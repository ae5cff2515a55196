"""KZG structured reference strings (port of `ezkl_tpu/plonk/srs.py`).

`gen_srs` creates the same INSECURE deterministic SRS as the JAX package
(tau derived from a seed, `srs.py:59-80`): tau^i scalars, then one batched
double-and-add scalar multiplication of the generator on the device, then
normalization to affine (z = 1). Artifacts live under
`~/.ezkl-tpu/srs/kzg{k}.srs` by default (`EZKL_TPU_SRS_REPO` moves them),
in the JAX package's versioned binary format: a file written by either
package loads in the other. The file holds the affine coordinates as
(16, n) u32 16-bit Montgomery limbs; the port converts them to and from its
(8, n) words at the boundary (`convert.py`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import struct

import numpy as np
import torch

from ..fieldmath import limbs, curve
from ..fieldmath.spec import bn254_fr, FR_MODULUS
from . import pairing

MAGIC = b"EZTPUSRS"
VERSION = 1
NLIMBS_REF = 16          # 16-bit limbs per coordinate in the file


@dataclasses.dataclass
class SRS:
    """g1[i] = tau^i * G1 (i < 2^k) as a batched device PointP; g2 powers
    [G2, tau*G2] as host affine Fq2 pairs."""

    k: int
    g1: curve.PointP          # batch (n,)
    g2: tuple                 # G2 generator (host)
    s_g2: tuple               # tau * G2 (host)

    @property
    def n(self) -> int:
        return 1 << self.k


def repo_dir() -> pathlib.Path:
    base = os.environ.get("EZKL_TPU_SRS_REPO", str(pathlib.Path.home() / ".ezkl-tpu" / "srs"))
    p = pathlib.Path(base)
    p.mkdir(parents=True, exist_ok=True)
    return p


def srs_path(k: int) -> pathlib.Path:
    return repo_dir() / f"kzg{k}.srs"


def gen_srs(k: int, seed: bytes = b"ezkl-tpu insecure srs", device=None) -> SRS:
    """INSECURE deterministic SRS (tau derived from seed). Test/dev only."""
    tau = int.from_bytes(hashlib.blake2b(seed, digest_size=32).digest(), "little") % FR_MODULUS
    n = 1 << k
    fr = bn254_fr()
    dev = limbs.device_of(device)
    powers_raw = limbs.from_mont(fr, limbs.powers(fr, tau, n, dev))
    bits = curve.scalars_to_bits(powers_raw)                   # (256, n)
    g1 = curve.scalar_mul(curve.generator((n,), dev), bits)
    ax, ay = curve.to_affine(g1)
    g1 = curve.from_affine(ax, ay)
    g2 = pairing.G2_GEN
    s_g2 = pairing.g2_mul(g2, tau)
    return SRS(k=k, g1=g1, g2=g2, s_g2=s_g2)


def truncate(srs: SRS, k: int) -> SRS:
    """Restrict to the first 2^k powers (for smaller circuits)."""
    assert k <= srs.k
    n = 1 << k
    return SRS(k=k, g1=srs.g1.map(lambda a: a[..., :n]), g2=srs.g2, s_g2=srs.s_g2)


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

def save(srs: SRS, path: str | os.PathLike | None = None) -> pathlib.Path:
    from ..convert import limbs_to_ref
    path = pathlib.Path(path) if path else srs_path(srs.k)
    ax, ay = curve.to_affine(srs.g1)
    inf = curve.is_identity(srs.g1).cpu().numpy()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", VERSION, srs.k))
        for coord in (srs.g2, srs.s_g2):
            for fq2 in coord:
                for c in fq2:
                    f.write(int(c).to_bytes(32, "little"))
        f.write(inf.astype(np.uint8).tobytes())
        f.write(limbs_to_ref(ax).tobytes())
        f.write(limbs_to_ref(ay).tobytes())
    return path


def load(path: str | os.PathLike, device=None) -> SRS:
    from ..convert import limbs_from_ref
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == MAGIC, "not an ezkl-tpu srs file"
    version, k = struct.unpack("<II", data[8:16])
    assert version == VERSION
    off = 16
    g2_vals = []
    for _ in range(8):
        g2_vals.append(int.from_bytes(data[off:off + 32], "little"))
        off += 32
    g2 = ((g2_vals[0], g2_vals[1]), (g2_vals[2], g2_vals[3]))
    s_g2 = ((g2_vals[4], g2_vals[5]), (g2_vals[6], g2_vals[7]))
    n = 1 << k
    dev = limbs.device_of(device)
    inf = np.frombuffer(data[off:off + n], dtype=np.uint8).astype(bool)
    off += n
    coords = []
    for _ in range(2):
        a = np.frombuffer(data[off:off + 4 * NLIMBS_REF * n], dtype=np.uint32)
        coords.append(limbs_from_ref(a.reshape(NLIMBS_REF, n), dev))
        off += 4 * NLIMBS_REF * n
    g1 = curve.from_affine(*coords, torch.from_numpy(inf).to(dev))
    return SRS(k=k, g1=g1, g2=g2, s_g2=s_g2)


def get_or_create(k: int, device=None) -> SRS:
    """Load ~/.ezkl-tpu/srs/kzg{k}.srs, or any larger cached one truncated;
    else generate-and-cache (insecure local gen)."""
    p = srs_path(k)
    if p.exists():
        return load(p, device)
    for bigger in sorted(repo_dir().glob("kzg*.srs")):
        try:
            kk = int(bigger.stem[3:])
        except ValueError:
            continue
        if kk > k:
            return truncate(load(bigger, device), k)
    srs = gen_srs(k, device=device)
    save(srs)
    return srs
