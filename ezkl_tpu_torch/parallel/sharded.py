"""Multi-device MSM and NTT over a mesh of torch devices (port of
`ezkl_tpu/parallel/sharded.py`).

The JAX package drives a `Mesh` of devices from one process with
`shard_map`. Here one process drives a mesh that is an ordered tuple of
`torch.device`s: each shard's work is issued on its own device (the kernels
launch asynchronously, so the devices run side by side) and the one
collective, the NTT's all_to_all, is block copies between the shards'
devices. A mesh may name one device more than once (four shards on one card
stand in for four cards), and CPU devices run the kernels' plain versions.

* `msm_sharded`: points/scalars split on the point axis; each shard runs the
  fused MSM (`kernels.msm.msm`) on its device; the D projective partials are
  copied to the first device and folded there (`msm.fold_points`).

* `ntt_sharded`: four-step NTT of N = R x C. Data lives as an (R, C) matrix
  M[r, c] = x[r + R*c], rows sharded. Steps: (1) local C-point NTTs along
  rows; (2) elementwise twiddle w^(r*c2); (3) all_to_all transpose to
  column sharding; (4) local R-point NTTs. Output Z[r2, c2] = X[C*r2 + c2]
  is the natural-order eval matrix. One all_to_all of the full N elements
  is the only cross-device traffic.

Every result is word for word the single-device one (exact integer
arithmetic, canonical Montgomery words), so proofs made under a mesh are
byte-equal to proofs made without it.
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..fieldmath import limbs
from ..fieldmath.curve import PointP
from ..fieldmath.spec import FieldSpec, NWORDS
from ..kernels import msm as msmmod
from ..kernels import ntt as nttmod

Mesh = tuple  # of torch.device, in shard order


def make_mesh(n: int | None = None, devices=None) -> Mesh:
    """The first `n` CUDA devices (all of them by default), or the explicit
    `devices` (e.g. ["cpu"] * 4, or ["cuda:0"] * 4 for a stand-in of four
    shards on one card). Never fewer devices than asked for: `n` above
    `torch.cuda.device_count()`, or unequal to len(devices), raises."""
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if not mesh or (n is not None and n != len(mesh)):
            raise ValueError(f"make_mesh: n={n} with {len(mesh)} devices")
        return mesh
    count = torch.cuda.device_count()
    n = count if n is None else n
    if n < 1 or n > count:
        raise ValueError(f"make_mesh: {n} devices asked, {count} CUDA devices present")
    return tuple(torch.device("cuda", i) for i in range(n))


# ---------------------------------------------------------------------------
# active-mesh registry: set a mesh here (or EZKL_TPU_MESH=<n>) and the
# prover's KZG commits dispatch through `msm_sharded` and its extended-coset
# transforms through `to_ext_sharded`
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Mesh | None = None
_ENV_CHECKED = False


def set_mesh(mesh: Mesh | None):
    """Install (or clear, with None) the mesh used by prover commits."""
    global _ACTIVE_MESH, _ENV_CHECKED
    _ACTIVE_MESH = mesh
    _ENV_CHECKED = True


def active_mesh() -> Mesh | None:
    """The installed mesh; on first call, EZKL_TPU_MESH=n installs the first
    n cards when n > 1 and that many exist."""
    global _ACTIVE_MESH, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        env = os.environ.get("EZKL_TPU_MESH")
        if env:
            n = int(env)
            if n > 1 and torch.cuda.device_count() >= n:
                _ACTIVE_MESH = make_mesh(n)
    return _ACTIVE_MESH


def _on(dev):
    """Make `dev` the current CUDA device while a shard's kernels launch."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _to(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(dev, non_blocking=True)


# ---------------------------------------------------------------------------
# MSM
# ---------------------------------------------------------------------------

def msm_sharded(mesh: Mesh, points: PointP, scalars: torch.Tensor,
                c: int | None = None, affine: bool = False) -> PointP:
    """Data-parallel MSM: points batch (N,), scalars (8, N) RAW Fr limbs. N
    must be divisible by the mesh size and the local shard size must be a
    power of two. Returns a projective PointP of batch () on the first
    device of the mesh; `affine` as in `msm.msm`."""
    d = len(mesh)
    n = scalars.shape[-1]
    local = n // d
    assert n % d == 0 and (local & (local - 1)) == 0, "bad shard size"
    if c is None:
        c = msmmod.default_window_bits(local)
    partials = []
    for i, dev in enumerate(mesh):
        lo, hi = i * local, (i + 1) * local
        with _on(dev):
            pts = points.map(lambda a: _to(a[:, lo:hi], dev))
            part = msmmod.msm(pts, _to(scalars[:, lo:hi], dev), c=c, affine=affine)
        partials.append(part.map(lambda a: _to(a, mesh[0])))
    with _on(mesh[0]):
        gathered = PointP(*(torch.stack([p[j] for p in partials], dim=-1) for j in range(3)))
        return msmmod.fold_points(gathered)                     # (8, D) -> ()


# ---------------------------------------------------------------------------
# NTT (four-step)
# ---------------------------------------------------------------------------

def _step2_twiddles(spec: FieldSpec, R: int, C: int, inverse: bool, device) -> torch.Tensor:
    """The w^(r*c2) table, (8, R, C) Montgomery, on `device`: the powers
    w^0 .. w^(N-1) built there (`limbs.powers`), gathered at r*c2 mod N;
    made once per (field, shape, direction, device)."""
    def make():
        n = R * C
        k = n.bit_length() - 1
        master = limbs.powers(spec, nttmod.root_of_unity(spec, k, inverse), n, device)
        r = torch.arange(R, device=master.device)
        c2 = torch.arange(C, device=master.device)
        return master[:, (r[:, None] * c2[None, :]) % n]
    return nttmod.dev_cached(("fs2", spec, R, C, inverse, str(device)), make)


def _shard_twiddles(mesh: Mesh, spec: FieldSpec, R: int, C: int, inverse: bool):
    """Shard i's rows of the step-2 table, on its device (a view of the
    table where devices repeat)."""
    rl = R // len(mesh)
    out = []
    for i, dev in enumerate(mesh):
        def block(i=i, dev=dev):
            with _on(dev):
                table = _step2_twiddles(spec, R, C, inverse, dev)
                return table[:, i * rl:(i + 1) * rl].contiguous()
        out.append(nttmod.dev_cached(("fs2", spec, R, C, inverse, str(dev), i, len(mesh)),
                                     block))
    return out


def ntt_sharded(mesh: Mesh, spec: FieldSpec, mat: torch.Tensor,
                inverse: bool = False) -> torch.Tensor:
    """Four-step NTT. `mat` is (8, *batch, R, C) with M[r, c] = x[r + R*c],
    its rows sharded over the mesh. Returns (8, *batch, R, C) with
    out[r2, c2] = X[C*r2 + c2] (natural order), on the input's device.

    For the inverse transform, pass the eval matrix in the same layout with
    inverse=True; output is the coefficient matrix (including 1/N scaling).
    """
    d = len(mesh)
    R, C = mat.shape[-2:]
    assert R % d == 0 and C % d == 0, f"({R}, {C}) does not shard on {d} devices"
    rl, cl = R // d, C // d
    tws = _shard_twiddles(mesh, spec, R, C, inverse)
    ys = []
    for i, dev in enumerate(mesh):
        with _on(dev):
            m = _to(mat[..., i * rl:(i + 1) * rl, :], dev)
            # step 1: C-point NTTs along the last axis (rows local); for the
            # inverse the two local 1/C and 1/R scalings compose to 1/N
            y = nttmod.ntt(spec, m, inverse=inverse)             # (8, *b, Rl, C)
            # step 2: the twiddle w^(r*c2)
            t = tws[i].reshape((NWORDS,) + (1,) * (y.dim() - 3) + (rl, C))
            ys.append(limbs.mont_mul(spec, y, t))
    outs = []
    for j, dev in enumerate(mesh):
        with _on(dev):
            # step 3: all_to_all -- shard j gathers column block j of every
            # shard's rows
            y = torch.cat([_to(y_i[..., j * cl:(j + 1) * cl], dev) for y_i in ys], dim=-2)
            # step 4: R-point NTTs along the row axis
            z = nttmod.ntt(spec, y.movedim(-2, -1), inverse=inverse)     # (8, *b, Cl, R)
            outs.append(z.movedim(-1, -2))                               # (8, *b, R, Cl)
    del ys
    with _on(mat.device):
        return torch.cat([_to(o, mat.device) for o in outs], dim=-1)


def to_fourstep_layout(x: torch.Tensor, R: int, C: int) -> torch.Tensor:
    """(8, N) natural coeffs -> (8, R, C) with M[r, c] = x[r + R*c]."""
    return x.reshape(NWORDS, C, R).transpose(1, 2)


def from_fourstep_layout(z: torch.Tensor) -> torch.Tensor:
    """(8, R, C) output (X[C*r2 + c2]) -> (8, N) natural order."""
    _, R, C = z.shape
    return z.reshape(NWORDS, R * C)


# ---------------------------------------------------------------------------
# batched sharded transforms -- the prover's domain-transform path
# ---------------------------------------------------------------------------

def shard_factors(mesh: Mesh, n: int) -> tuple[int, int] | None:
    """(R, C) with R*C == n, both divisible by the mesh size and each a
    power of two -- or None if n can't shard on this mesh."""
    d = len(mesh)
    if d < 2 or n < d * d or (n & (n - 1)):
        return None
    k = n.bit_length() - 1
    R = 1 << (k // 2)
    C = n // R
    if R % d or C % d:
        R, C = C, R
    if R % d or C % d:
        return None
    return R, C


def ntt_sharded_batched(mesh: Mesh, spec: FieldSpec, x: torch.Tensor,
                        inverse: bool = False) -> torch.Tensor:
    """Sharded four-step NTT of a BATCH of polys: x is (8, B, n) in natural
    order (coeffs forward / evals inverse); returns (8, B, n) natural
    order, word for word the single-device transform."""
    _, B, n = x.shape
    fac = shard_factors(mesh, n)
    assert fac is not None, f"n={n} not shardable on {len(mesh)} devices"
    R, C = fac
    mat = x.reshape(NWORDS, B, C, R).transpose(2, 3)            # (8, B, R, C)
    return ntt_sharded(mesh, spec, mat, inverse).reshape(NWORDS, B, n)


def to_ext_sharded(mesh: Mesh, dom, v: torch.Tensor) -> torch.Tensor:
    """Sharded lagrange -> extended-coset transform for a (B, 8, n) column
    stack (or (8, n)): iNTT over H, zero-pad, coset-scale, NTT over the
    extended domain -- each transform four-step sharded when its size
    shards on the mesh, single-device otherwise. Matches
    `Domain.coeff_to_extended(intt(v))` word for word."""
    spec = dom.spec
    single = v.dim() == 2
    vv = (v[None] if single else v).movedim(1, 0)              # (8, B, n)
    n, ext = dom.n, dom.n_ext
    if shard_factors(mesh, n) is not None:
        coeff = ntt_sharded_batched(mesh, spec, vv, inverse=True)
    else:
        coeff = nttmod.intt(spec, vv)
    pad = torch.zeros((NWORDS, coeff.shape[1], ext - n), dtype=coeff.dtype,
                      device=coeff.device)
    padded = torch.cat([coeff, pad], dim=-1)
    del coeff
    gp = nttmod._coset_powers(spec, ext, False, padded.device)
    scaled = limbs.mont_mul(spec, padded, gp[:, None, :])
    del padded
    if shard_factors(mesh, ext) is not None:
        out = ntt_sharded_batched(mesh, spec, scaled)
    else:
        out = nttmod.ntt(spec, scaled)
    out = out.movedim(0, 1)                                     # (B, 8, ext)
    return out[0] if single else out
