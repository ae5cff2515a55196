"""Proof creation (port of `ezkl_tpu/plonk/prover.py`).

Protocol, transcript order and blinding are the JAX package's, so a
seeded proof is byte-identical to the reference's:
 1. absorb vk repr + instance values
 2. per advice phase: commit advice columns, absorb, squeeze phase challenges
 3. theta; lookup multiplicities m committed
 4. beta, gamma; permutation Z chunks + lookup grand-sum phi + shuffle Z and
    the random poly committed in one batched MSM
 5. y; quotient h over the extended coset, split, committed
 6. x; all query evaluations absorbed
 7. GWC multiopen: v (intra-point RLC), one witness commitment per point

The reference's five jitted stage functions (`ProverKernels`, :210-582) are
plain functions here: PyTorch runs eagerly, and every field multiply, NTT
stage and point operation on the card is one launch of a hand-written
kernel. The quotient (phase 5) bounds its device memory for k = 20 on one
card: the columns reach the extended coset in groups of columns, and each
term is folded into a running sum as it is built. `_ProveCheckpoint` makes
the phases restartable, with the JAX package's directory key and file
layout. Under an active mesh (`parallel.sharded`) the commitments and the
transforms to the extended coset run sharded; the proof's bytes do not
change.
"""

from __future__ import annotations

import dataclasses
import json
import os as _os
import pathlib
import time as _time
from collections import defaultdict

import numpy as np
import torch

from ..fieldmath import limbs
from ..fieldmath.spec import bn254_fr, NLIMBS, NWORDS
from ..kernels import ntt as nttmod
from ..parallel import sharded
from . import kzg
from .assign import Assignment
from .cs import FIXED, ADVICE, INSTANCE, last_active_row
from .domain import Domain
from .evaluator import EvalCtx, evaluate
from .keygen import ProvingKey, DELTA
from .srs import SRS
from .transcript import Transcript

FR = bn254_fr()

# phase name -> seconds of the last create_proof (read by chip_smoke.py);
# each span ends at the next `_span` call or at "done"
PHASE_SECONDS: dict = {}
# phase name -> the card's peak allocated bytes during the phase (CUDA only:
# `torch.cuda.max_memory_allocated`, its peak reset at each phase start;
# "(before)": the peak since the caller's last reset, up to the first phase;
# so the largest value is the peak of the caller's span)
PHASE_PEAK_BYTES: dict = {}
_PHASE = None          # (name, start time, profiler range) of the running phase
# extended-coset elements a group of columns of the quotient transforms
# together (8 columns of 2^23 at k = 20: 2 GiB a copy; every column of a
# k <= 14 prove in one group)
EXT_GROUP_ELEMENTS = 1 << 26


def _span(msg: str, device=None):
    """Start phase `msg` (or close the last one at "done"), synchronizing
    the card first so that each phase's time is its own. Each phase is also
    a `torch.profiler` range of the same name
    (`tools/profile_torch_prove.py` reads it)."""
    global _PHASE
    cuda = device is not None and device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    now = _time.perf_counter()
    opened = _PHASE is not None
    if opened:
        PHASE_SECONDS[_PHASE[0]] = now - _PHASE[1]
        if cuda:
            PHASE_PEAK_BYTES[_PHASE[0]] = torch.cuda.max_memory_allocated(device)
        _PHASE[2].__exit__(None, None, None)
    _PHASE = None
    if msg != "done":
        if cuda:
            if not opened:       # the caller's peak up to the first phase
                PHASE_PEAK_BYTES["(before)"] = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        span = torch.profiler.record_function(msg)
        span.__enter__()
        _PHASE = (msg, now, span)


@dataclasses.dataclass
class Proof:
    """Transcript-ordered proof contents (host-side ints/points)."""

    advice_commitments: list
    lookup_m_commitments: list
    perm_z_commitments: list
    lookup_phi_commitments: list
    shuffle_z_commitments: list
    random_commitment: object   # blinding poly commitment (host affine)
    h_commitments: list
    evals: dict                 # label -> int
    opening_commitments: list   # one per distinct point
    instances: list[list[int]]

    def to_json(self):
        import json

        def pt(p):
            return None if p is None else [hex(p[0]), hex(p[1])]

        return json.dumps({
            "advice": [pt(p) for p in self.advice_commitments],
            "lookup_m": [pt(p) for p in self.lookup_m_commitments],
            "perm_z": [pt(p) for p in self.perm_z_commitments],
            "lookup_phi": [pt(p) for p in self.lookup_phi_commitments],
            "shuffle_z": [pt(p) for p in self.shuffle_z_commitments],
            "random": pt(self.random_commitment),
            "h": [pt(p) for p in self.h_commitments],
            "evals": {k: hex(v) for k, v in self.evals.items()},
            "openings": [pt(p) for p in self.opening_commitments],
            "instances": [[hex(v) for v in col] for col in self.instances],
        }, indent=1)

    @classmethod
    def from_json(cls, s: str):
        import json

        d = json.loads(s)

        def pt(p):
            return None if p is None else (int(p[0], 16), int(p[1], 16))

        return cls(
            advice_commitments=[pt(p) for p in d["advice"]],
            lookup_m_commitments=[pt(p) for p in d["lookup_m"]],
            perm_z_commitments=[pt(p) for p in d["perm_z"]],
            lookup_phi_commitments=[pt(p) for p in d["lookup_phi"]],
            shuffle_z_commitments=[pt(p) for p in d.get("shuffle_z", [])],
            random_commitment=pt(d["random"]),
            h_commitments=[pt(p) for p in d["h"]],
            evals={k: int(v, 16) for k, v in d["evals"].items()},
            opening_commitments=[pt(p) for p in d["openings"]],
            instances=[[int(v, 16) for v in col] for col in d["instances"]],
        )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _running_sum(v):
    """Exclusive prefix sum along the last axis (field add)."""
    incl = limbs.prefix_scan_add(FR, v)
    return torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)


def _running_product(v):
    """Exclusive prefix product along the last axis (starts at 1)."""
    incl = limbs.prefix_scan_mul(FR, v)
    one = limbs.ones_mont(FR, v.shape[1:-1] + (1,), v.device)
    return torch.cat([one, incl[..., :-1]], dim=-1)


def _lagrange_bases_ext(dom: Domain, indices: tuple, device) -> torch.Tensor:
    """[l_i over the extended coset for i in indices] as (8, B, n_ext)."""
    e = torch.zeros((NWORDS, len(indices), dom.n), dtype=torch.int32, device=device)
    one = limbs.const(FR, 1, device=device)
    for b, idx in enumerate(indices):
        e[:, b, idx] = one
    return dom.coeff_to_extended(nttmod.intt(FR, e))


def _eval_label(kind: str, index: int, rotation: int) -> str:
    return f"{kind}{index}@{rotation}"


def _bcast(s, shape):
    return s.reshape((NWORDS,) + (1,) * (len(shape) - 1)).expand(shape)


# ---------------------------------------------------------------------------
# per-circuit stages (cached on the ProvingKey)
# ---------------------------------------------------------------------------

class ProverKernels:
    """The reference's stage functions for one (cs, domain) pair, as plain
    functions. Challenges are (8,) Montgomery scalars on the device."""

    def __init__(self, pk: ProvingKey):
        cs = pk.vk.cs
        dom = pk.vk.domain
        dev = pk.device
        n = dom.n
        ext = dom.n_ext
        m_perm = len(cs.perm_columns)
        chunk = cs.perm_chunk_size()
        self.chunks = [list(range(i, min(i + chunk, m_perm)))
                       for i in range(0, m_perm, chunk)] if chunk else []
        self.cs, self.dom, self.pk, self.dev = cs, dom, pk, dev
        self.n, self.ext, self.step, self.m_perm = n, ext, ext // n, m_perm

        self.wpow = limbs.powers(FR, dom.omega, n, dev)
        self.dpow = limbs.powers(FR, DELTA, max(m_perm, 1), dev)
        self.coset_pts = limbs.mont_mul(
            FR, limbs.powers(FR, dom.omega_ext, ext, dev),
            limbs.const(FR, FR.generator, device=dev)[:, None])
        a = last_active_row(n)
        self.a = a
        # all needed basis vectors in ONE batched transform: l_0, l_a, and
        # the blinding rows (a, n)
        bases = _lagrange_bases_ext(dom, (0, a) + tuple(range(a + 1, n)), dev)
        self.l0_ext = bases[:, 0].clone()
        self.llast_ext = bases[:, 1].clone()              # closing row basis
        self.one_ext = limbs.ones_mont(FR, (ext,), dev)
        # not_active = 1 - sum_{i in [a, n)} l_i: masks the running
        # constraints off the closing + blinding rows
        blind_sum = self.llast_ext
        for i in range(bases.shape[1] - 2):
            blind_sum = limbs.add(FR, blind_sum, bases[:, 2 + i])
        self.not_last = limbs.sub(FR, self.one_ext, blind_sum)
        del bases, blind_sum

        self.term_descs = ([("gate", i) for i in range(len(cs.gates))]
                           + sum(([("perm_run", ci), ("perm_bound", ci)]
                                  + ([("perm_last", ci)] if ci == len(self.chunks) - 1 else [])
                                  for ci in range(len(self.chunks))), [])
                           + sum([[("lk_run", li), ("lk_l0", li), ("lk_last", li)]
                                  for li in range(len(cs.lookups))], [])
                           + sum([[("sh_run", si), ("sh_l0", si), ("sh_last", si)]
                                  for si in range(len(cs.shuffles))], []))

    def _ctx(self, cols, rot_step, ch_list):
        return EvalCtx(columns=cols, rot_step=rot_step,
                       challenges={i: c for i, c in enumerate(ch_list)})

    @staticmethod
    def compress(tup, ctx, theta):
        acc = None
        for e in tup:
            v = evaluate(e, ctx)
            acc = v if acc is None else limbs.add(
                FR, limbs.mont_mul(FR, acc, _bcast(theta, v.shape)), v)
        return acc

    # ---- stage A: lookup + shuffle compression over H --------------------
    def stage_compress(self, advice_l, fixed_l, instance_l, theta, *ch):
        cs = self.cs
        ctx = self._ctx({FIXED: fixed_l, ADVICE: advice_l, INSTANCE: instance_l}, 1, ch)
        fs_all, t_all = [], []
        for lk in cs.lookups:
            fs_all.append([self.compress(tup, ctx, theta) for tup in lk.inputs])
            t_all.append(self.compress(lk.table, ctx, theta))
        sh_in_all, sh_t_all = [], []
        for sh in cs.shuffles:
            sh_in_all.append(self.compress(sh.input, ctx, theta))
            sh_t_all.append(self.compress(sh.table, ctx, theta))
        return fs_all, t_all, sh_in_all, sh_t_all

    # ---- stage B: permutation Z + lookup phi + shuffle Z -----------------
    def stage_zphi(self, advice_l, fixed_l, instance_l, beta, gamma,
                   fs_all, t_all, m_all, sh_in_all, sh_t_all):
        cs, n, a = self.cs, self.n, self.a
        cols = {FIXED: fixed_l, ADVICE: advice_l, INSTANCE: instance_l}
        bb, gg = beta[:, None], gamma[:, None]
        sigma_l = self.pk.sigma_lagrange

        z_list = []
        carry = limbs.const(FR, 1, device=self.dev)
        for cset in self.chunks:
            num = den = None
            for j in cset:
                c = cs.perm_columns[j]
                v = cols[c.kind][c.index]
                idj = limbs.mont_mul(FR, self.dpow[:, j][:, None], self.wpow)
                fa = limbs.add(FR, limbs.add(FR, v, limbs.mont_mul(FR, bb, idj)), gg)
                fb = limbs.add(FR, limbs.add(FR, v, limbs.mont_mul(FR, bb, sigma_l[j])), gg)
                num = fa if num is None else limbs.mont_mul(FR, num, fa)
                den = fb if den is None else limbs.mont_mul(FR, den, fb)
            ratio = limbs.mont_mul(FR, num, limbs.batch_inv(FR, den))
            z = limbs.mont_mul(FR, _running_product(ratio), carry[:, None])
            carry = z[..., a]        # closing row (blind rows follow)
            z_list.append(z)

        phi_list = []
        active = torch.arange(n, device=self.dev) < a
        for fs, t, m_dev in zip(fs_all, t_all, m_all):
            inv_f = [limbs.batch_inv(FR, limbs.add(FR, f, bb)) for f in fs]
            inv_t = limbs.batch_inv(FR, limbs.add(FR, t, bb))
            term = None
            for invf in inv_f:
                term = invf if term is None else limbs.add(FR, term, invf)
            term = limbs.sub(FR, term, limbs.mont_mul(FR, m_dev, inv_t))
            term = limbs.select(active, term, torch.zeros_like(term))
            phi_list.append(_running_sum(term))

        shz_list = []
        one_col = limbs.ones_mont(FR, (n,), self.dev)
        for sa, sb in zip(sh_in_all, sh_t_all):
            # blind-row factors forced to 1 so z[a] is the active-row product
            num = limbs.select(active, limbs.add(FR, sa, gg), one_col)
            den = limbs.select(active, limbs.add(FR, sb, gg), one_col)
            ratio = limbs.mont_mul(FR, num, limbs.batch_inv(FR, den))
            shz_list.append(_running_product(ratio))
        return z_list, phi_list, shz_list

    # ---- stage C: quotient over the extended coset -----------------------
    def stage_to_ext(self, advice_l, fixed_l, instance_l, z_list, phi_list, m_all, shz_list):
        """Every column stack to the extended coset, in groups of columns
        of at most EXT_GROUP_ELEMENTS extended elements (one group below
        k = 15) written into one (C, 8, n_ext) tensor, so that a transform's
        copies hold one group, not every column. (The reference pads the
        stack to a power of two to reuse one compiled executable; results
        do not depend on it, so no padding.)"""
        cs, dev = self.cs, self.dev
        stacks = ([s for s, nz in ((fixed_l, cs.num_fixed), (advice_l, cs.num_advice),
                                   (instance_l, cs.num_instance),
                                   (self.pk.sigma_lagrange, self.m_perm)) if nz]
                  + [s[None] for s in list(z_list) + list(phi_list) + list(m_all)
                     + list(shz_list)])
        empty = torch.zeros((0, NWORDS, self.ext), dtype=torch.int32, device=dev)
        if not stacks:
            return {FIXED: empty, ADVICE: empty, INSTANCE: empty}, empty, [], [], [], []
        rows = [(s, i) for s in stacks for i in range(s.shape[0])]
        ext_all = torch.empty((len(rows), NWORDS, self.ext), dtype=torch.int32, device=dev)
        per = max(1, EXT_GROUP_ELEMENTS // self.ext)
        # under a mesh whose shards divide the extended domain, the group's
        # transforms run four-step sharded (`ezkl_tpu/plonk/prover.py:375-385`),
        # word for word the single-device result
        mesh = sharded.active_mesh()
        if mesh is not None and sharded.shard_factors(mesh, self.ext) is None:
            mesh = None
        for c0 in range(0, len(rows), per):
            big = torch.stack([s[i] for s, i in rows[c0:c0 + per]], dim=1)    # (8, g, n)
            if mesh is not None:
                ext_all[c0:c0 + per] = sharded.to_ext_sharded(mesh, self.dom, big.movedim(1, 0))
            else:
                ext_all[c0:c0 + per] = self.dom.coeff_to_extended(
                    nttmod.intt(FR, big)).movedim(1, 0)
            del big
        off = 0

        def take(cnt):
            nonlocal off
            out = ext_all[off:off + cnt]
            off += cnt
            return out

        cols_ext = {kind: take(num) if num else empty for kind, num in
                    ((FIXED, cs.num_fixed), (ADVICE, cs.num_advice),
                     (INSTANCE, cs.num_instance))}
        sig_ext = take(self.m_perm) if self.m_perm else empty
        z_ext = [take(1)[0] for _ in z_list]
        phi_ext = [take(1)[0] for _ in phi_list]
        m_ext = [take(1)[0] for _ in m_all]
        shz_ext = [take(1)[0] for _ in shz_list]
        return cols_ext, sig_ext, z_ext, phi_ext, m_ext, shz_ext

    def build_term(self, desc, cols_ext, sig_ext, z_ext, phi_ext, m_ext, shz_ext,
                   theta, beta, gamma, ch):
        cs, step, a, ext = self.cs, self.step, self.a, self.ext
        kind, idx = desc
        bb, gg = beta[:, None], gamma[:, None]
        ctx = self._ctx(cols_ext, step, ch)
        mul = lambda x, y: limbs.mont_mul(FR, x, y)     # noqa: E731
        if kind == "gate":
            return evaluate(cs.gates[idx].poly, ctx)
        if kind == "perm_run":
            z_e = z_ext[idx]
            z_next = torch.roll(z_e, -step, dims=-1)
            num = den = None
            for j in self.chunks[idx]:
                c = cs.perm_columns[j]
                v = cols_ext[c.kind][c.index]
                idj = mul(self.dpow[:, j][:, None], self.coset_pts)
                fa = limbs.add(FR, limbs.add(FR, v, mul(bb, idj)), gg)
                fb = limbs.add(FR, limbs.add(FR, v, mul(bb, sig_ext[j])), gg)
                num = fa if num is None else mul(num, fa)
                den = fb if den is None else mul(den, fb)
            running = limbs.sub(FR, mul(z_next, den), mul(z_e, num))
            return mul(self.not_last, running)
        if kind == "perm_bound":
            z_e = z_ext[idx]
            if idx == 0:
                return mul(self.l0_ext, limbs.sub(FR, z_e, self.one_ext))
            # carry constraint: z_i(0) == z_{i-1}(closing row a)
            prev_last = torch.roll(z_ext[idx - 1], -(a * step) % ext, dims=-1)
            return mul(self.l0_ext, limbs.sub(FR, z_e, prev_last))
        if kind == "perm_last":
            return mul(self.llast_ext, limbs.sub(FR, z_ext[idx], self.one_ext))
        if kind in ("sh_run", "sh_l0", "sh_last"):
            sh = cs.shuffles[idx]
            z_e = shz_ext[idx]
            if kind == "sh_l0":
                return mul(self.l0_ext, limbs.sub(FR, z_e, self.one_ext))
            if kind == "sh_last":
                return mul(self.llast_ext, limbs.sub(FR, z_e, self.one_ext))
            a_e = limbs.add(FR, self.compress(sh.input, ctx, theta), gg)
            b_e = limbs.add(FR, self.compress(sh.table, ctx, theta), gg)
            z_next = torch.roll(z_e, -step, dims=-1)
            running = limbs.sub(FR, mul(z_next, b_e), mul(z_e, a_e))
            return mul(self.not_last, running)
        lk = cs.lookups[idx]
        phi_e = phi_ext[idx]
        if kind == "lk_l0":
            return mul(self.l0_ext, phi_e)
        if kind == "lk_last":
            return mul(self.llast_ext, phi_e)
        # lk_run
        m_e = m_ext[idx]
        f_exts = [limbs.add(FR, self.compress(tup, ctx, theta), bb) for tup in lk.inputs]
        t_e = limbs.add(FR, self.compress(lk.table, ctx, theta), bb)
        prod_f = None
        for fpb in f_exts:
            prod_f = fpb if prod_f is None else mul(prod_f, fpb)
        if len(f_exts) == 1:
            sum_except = self.one_ext
        else:
            sum_except = None
            for kk in range(len(f_exts)):
                pr = None
                for jj, fpb in enumerate(f_exts):
                    if jj == kk:
                        continue
                    pr = fpb if pr is None else mul(pr, fpb)
                sum_except = pr if sum_except is None else limbs.add(FR, sum_except, pr)
        phi_next = torch.roll(phi_e, -step, dims=-1)
        diff = limbs.sub(FR, phi_next, phi_e)
        lhs = mul(mul(diff, prod_f), t_e)
        rhs = limbs.sub(FR, mul(t_e, sum_except), mul(m_e, prod_f))
        return mul(self.not_last, limbs.sub(FR, lhs, rhs))

    def stage_combine(self, acc):
        """h = acc / Z_H over the extended coset, back to coefficients, split
        into n-sized pieces; acc is the terms' sum_i y^(T-1-i) * t_i."""
        n = self.n
        h_ext = limbs.mont_mul(FR, acc, self.dom.vanishing_inv_on_extended(self.dev))
        h_coeff = self.dom.extended_to_coeff(h_ext)
        return [h_coeff[..., i * n:(i + 1) * n] for i in range(self.ext // n)]

    def stage_quotient(self, advice_l, fixed_l, instance_l, theta, beta, gamma,
                       y, z_list, phi_list, m_all, shz_list, *ch):
        """Each term is folded into a running sum as it is built, acc =
        acc * y + t_i in `term_descs` order, so one term lives at a time;
        the sum is the reference's sum_i y^(T-1-i) * t_i, the same
        canonical words."""
        exts = self.stage_to_ext(advice_l, fixed_l, instance_l,
                                 z_list, phi_list, m_all, shz_list)
        acc = None
        for d in self.term_descs:
            t = self.build_term(d, *exts, theta, beta, gamma, list(ch))
            acc = t if acc is None else limbs.add(
                FR, limbs.mont_mul(FR, acc, y[:, None]), t)
            del t
        del exts
        return self.stage_combine(acc)

    # ---- stage D: batched evaluation at an opening point -----------------
    def stage_eval(self, coeff_stack, z_mont):
        """coeff_stack (Q, 8, n) all at the SAME point -> (Q, 8)."""
        pw = limbs.powers_dynamic(FR, z_mont, self.n)
        prod = limbs.mont_mul(FR, coeff_stack.movedim(0, 1), pw[:, None, :])
        return kzg._sum_last(prod).movedim(0, 1)

    # ---- stage E: one opening witness ------------------------------------
    def stage_open(self, lagrange_stack, evals_stack, v_ch, z_mont):
        """RLC-combine polys (Q, 8, n evals over H) + values (Q, 8), build
        (q - v)/(X - z) witness evals over H."""
        q_comb = lagrange_stack[0]
        v_comb = evals_stack[0]
        for i in range(1, lagrange_stack.shape[0]):
            q_comb = limbs.add(FR, limbs.mont_mul(FR, q_comb, v_ch[:, None]), lagrange_stack[i])
            v_comb = limbs.add(FR, limbs.mont_mul(FR, v_comb, v_ch), evals_stack[i])
        inv = limbs.batch_inv(FR, limbs.sub(FR, self.wpow, z_mont[:, None]))
        return limbs.mont_mul(FR, limbs.sub(FR, q_comb, v_comb[:, None]), inv)


def _kernels(pk: ProvingKey) -> ProverKernels:
    kern = getattr(pk, "_kernels", None)
    if kern is None:
        kern = ProverKernels(pk)
        pk._kernels = kern
    return kern


# ---------------------------------------------------------------------------
# the prover
# ---------------------------------------------------------------------------

class _ProveCheckpoint:
    """Restartable prover phases for long (k >= 20) runs (the JAX package's
    `_ProveCheckpoint`, `prover.py:597-660`): the two expensive cut points,
    after every column commitment (phase 4b, "cols") and after the quotient
    commitment (phase 5b, "h"), are saved, so a crashed run resumes with at
    most one phase of rework. Enabled by `create_proof(...,
    checkpoint_dir=...)` or EZKL_TPU_CKPT_DIR.

    A checkpoint holds the blinded columns (npz), the transcript state and
    the squeezed challenges (JSON), under a directory keyed by (vk repr,
    witness, instance, seed), so a resume continues byte-identical to the
    uninterrupted proof and another witness or seed never picks up stale
    state. Cleared on success. The key, the npz arrays ((C, 16, n) and
    (16, n) uint32 16-bit limbs) and the JSON are the JAX package's, so a
    checkpoint of either package resumes in the other."""

    def __init__(self, root, pk, asg, seed):
        import hashlib
        from ..convert import stack_to_ref
        h = hashlib.blake2b(digest_size=16)
        h.update(pk.vk.transcript_repr())
        h.update(stack_to_ref(asg.advice).tobytes())
        h.update(repr(asg.instance).encode())
        h.update(str(seed).encode())
        self.dir = pathlib.Path(root) / f"prove-{h.hexdigest()}"
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, name: str, tr, meta: dict, arrays: dict):
        """arrays: name -> (C, 8, n) or (8, n) tensor, or a list of them."""
        from ..convert import limbs_to_ref, stack_to_ref

        def to_ref(t):
            return stack_to_ref(t) if t.dim() == 3 else limbs_to_ref(t)
        flat = {}
        for kk, v in arrays.items():
            if isinstance(v, (list, tuple)):
                flat[f"{kk}__len"] = np.asarray(len(v))
                for i, a in enumerate(v):
                    flat[f"{kk}__{i}"] = to_ref(a)
            else:
                flat[kk] = to_ref(v)
        # np.savez appends ".npz" to a name without it: keep the temporary
        # name suffixed so that the write lands where the rename expects
        tmp = self.dir / f".{name}.tmp.npz"
        np.savez(tmp, **flat)
        tmp.rename(self.dir / f"{name}.npz")
        meta = dict(meta, transcript_state=tr._state.hex())
        (self.dir / f"{name}.json").write_text(json.dumps(meta))

    def load(self, name: str, device):
        from ..convert import limbs_from_ref, stack_from_ref

        def from_ref(a):
            return stack_from_ref(a, device) if a.ndim == 3 else limbs_from_ref(a, device)
        jf, nf = self.dir / f"{name}.json", self.dir / f"{name}.npz"
        if not (jf.exists() and nf.exists()):
            return None
        meta = json.loads(jf.read_text())
        arrays = {}
        with np.load(nf) as data:
            for kk in data.files:
                if kk.endswith("__len"):
                    base = kk[:-5]
                    arrays[base] = [from_ref(data[f"{base}__{i}"])
                                    for i in range(int(data[kk]))]
                elif "__" not in kk:
                    arrays[kk] = from_ref(data[kk])
        return meta, arrays

    def clear(self):
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


def _pts_meta(pts):
    """Host affine points -> JSON-able [[hex, hex] | None]."""
    return [None if p is None else [hex(p[0]), hex(p[1])] for p in pts]


def _pts_unmeta(pts):
    return [None if p is None else (int(p[0], 16), int(p[1], 16)) for p in pts]


def _rng_for_proof(seed: int | None) -> np.random.Generator:
    if seed is None:
        env = _os.environ.get("EZKL_TPU_DET_SEED")
        if env is not None:
            seed = int(env)
    if seed is None:
        seed = int.from_bytes(_os.urandom(16), "little")
    return np.random.default_rng(seed)


def _random_mont(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """Fresh blinding field elements as Montgomery limbs: the reference's
    draw of (16, *shape) 16-bit limbs with the top limb masked (values
    < 2^253), packed two limbs per 32-bit word."""
    raw = rng.integers(0, 1 << 16, size=(NLIMBS,) + tuple(shape),
                       dtype=np.int64).astype(np.uint32)
    raw[NLIMBS - 1] &= 0x1FFF
    words = raw[0::2] | (raw[1::2] << np.uint32(16))
    return limbs.to_mont(FR, limbs.to_device(words, device))


def create_proof(pk: ProvingKey, srs: SRS, asg: Assignment,
                 transcript: Transcript | None = None,
                 seed: int | None = None,
                 checkpoint_dir: str | None = None) -> Proof:
    cs = pk.vk.cs
    dom = pk.vk.domain
    n = dom.n
    dev = pk.device
    tr = transcript or Transcript()
    kern = _kernels(pk)
    chunks = kern.chunks
    m_perm = len(cs.perm_columns)
    a = kern.a
    rng = _rng_for_proof(seed)
    _span("done", dev)                 # a phase left open by a prove that raised
    PHASE_SECONDS.clear()
    PHASE_PEAK_BYTES.clear()

    ckpt_root = checkpoint_dir or _os.environ.get("EZKL_TPU_CKPT_DIR")
    if ckpt_root and seed is None and _os.environ.get("EZKL_TPU_DET_SEED") is None:
        raise ValueError(
            "checkpointed proving needs a deterministic seed (seed= or "
            "EZKL_TPU_DET_SEED): a resume must replay the same blinding")
    ckpt = _ProveCheckpoint(ckpt_root, pk, asg, seed) if ckpt_root else None

    def blind_tail(cols, unblinded_mask=None):
        """Randomize rows (a, n) of a (..., 8, n) Montgomery column stack.
        unblinded_mask: optional (C,) bool of columns whose tail stays."""
        nb = n - a - 1
        r = _random_mont(rng, cols.shape[:-2] + (nb,), dev)
        out = cols.clone()
        if cols.dim() == 3:
            r = r.movedim(1, 0)               # (C, 8, nb)
            if unblinded_mask is not None and unblinded_mask.any():
                keep = torch.from_numpy(unblinded_mask).to(dev)[:, None, None]
                r = torch.where(keep, cols[:, :, a + 1:], r)
            out[:, :, a + 1:] = r
        else:
            out[:, a + 1:] = r
        return out

    fixed_l = pk.fixed_lagrange
    instance_l = asg.instance_device(dev)
    cols_st = ckpt.load("cols", dev) if ckpt else None
    if cols_st is None:
        # (the JAX package drops compiled executables here and around phase
        # 5, `_maybe_release_executables`, to free TPU memory: PyTorch keeps
        # no compiled programs, so nothing is ported for it)
        _span("phase1: bind vk+instances", dev)
        tr.common_bytes(pk.vk.transcript_repr())
        for col in asg.instance:
            for v in col:
                tr.common_scalar(v)

        _span("phase2: advice commitments", dev)
        phases = asg.cs.advice_phase
        p0_cols = [i for i in range(cs.num_advice) if phases[i] == 0]
        p1_cols = [i for i in range(cs.num_advice) if phases[i] != 0]

        unbl = np.asarray([bool(b) for b in cs.advice_unblinded], bool) \
            if cs.advice_unblinded else np.zeros(cs.num_advice, bool)
        advice_l = blind_tail(asg.device_columns(ADVICE, dev), unbl)  # (na, 8, n)
        advice_comms: dict[int, object] = {}
        if p0_cols:
            for i, c in zip(p0_cols, kzg.commit_many(srs, advice_l[p0_cols])):
                advice_comms[i] = c
                tr.common_point(c)
        challenges = [tr.challenge() for _ in range(cs.num_challenges)]
        ch_dev = [limbs.const(FR, v, device=dev) for v in challenges]
        if p1_cols:
            asg.apply_phase1({i: v for i, v in enumerate(challenges)})
            refreshed = blind_tail(asg.device_columns(ADVICE, dev), unbl)
            # keep the already-committed phase-0 blinding rows byte-identical
            keep = torch.tensor([phases[i] == 0 for i in range(cs.num_advice)], device=dev)
            advice_l = torch.where(keep[:, None, None], advice_l, refreshed)
            for i, c in zip(p1_cols, kzg.commit_many(srs, advice_l[p1_cols])):
                advice_comms[i] = c
                tr.common_point(c)
        advice_comms = [advice_comms[i] for i in range(cs.num_advice)]

        _span("phase3: lookups m", dev)
        theta = tr.challenge()
        theta_dev = limbs.const(FR, theta, device=dev)
        fs_all, t_all, sh_in_all, sh_t_all = kern.stage_compress(
            advice_l, fixed_l, instance_l, theta_dev, *ch_dev)
        m_all = []
        for lk, fs, t in zip(cs.lookups, fs_all, t_all):
            # multiplicity counting: pack field elements into structured u64
            # rows, sorted-match inputs against the table, count per
            # first-occurrence table row
            t_pack = limbs.pack_rows(limbs.from_mont(FR, t))[:a]
            order = np.argsort(t_pack, kind="stable")
            t_sorted = t_pack[order]
            f_all = np.concatenate([limbs.pack_rows(limbs.from_mont(FR, f))[:a] for f in fs])
            pos = np.searchsorted(t_sorted, f_all)
            pos_c = np.minimum(pos, t_sorted.size - 1)
            ok = t_sorted[pos_c] == f_all
            if not ok.all():
                raise ValueError(
                    f"lookup '{lk.name}': {int((~ok).sum())} input values not in table")
            run_start = np.r_[True, t_sorted[1:] != t_sorted[:-1]]
            run_first = np.maximum.accumulate(
                np.where(run_start, np.arange(t_sorted.size), 0))
            rows_for_f = order[run_first[pos_c]]
            m_host = np.bincount(rows_for_f, minlength=n).astype(np.int64)
            m_dev = limbs.to_mont(FR, limbs.to_device(limbs.encode_i64(FR, m_host), dev))
            m_all.append(blind_tail(m_dev))
        m_comms = kzg.commit_many(srs, m_all)
        for cpt in m_comms:
            tr.common_point(cpt)

        _span("phase4: perm z + phi", dev)
        beta = tr.challenge()
        gamma = tr.challenge()
        beta_dev = limbs.const(FR, beta, device=dev)
        gamma_dev = limbs.const(FR, gamma, device=dev)
        z_list, phi_list, shz_list = kern.stage_zphi(
            advice_l, fixed_l, instance_l, beta_dev, gamma_dev, fs_all, t_all,
            m_all, sh_in_all, sh_t_all)
        z_list = [blind_tail(z) for z in z_list]
        phi_list = [blind_tail(phi) for phi in phi_list]
        shz_list = [blind_tail(z) for z in shz_list]
        # one batched MSM for z + phi + shuffle-z + the vanishing random poly
        _span("phase4b: random poly", dev)
        r_evals = _random_mont(rng, (n,), dev)
        batch_comms = kzg.commit_many(srs, z_list + phi_list + shz_list + [r_evals])
        for cpt in batch_comms:
            tr.common_point(cpt)
        nz, nphi, nshz = len(z_list), len(phi_list), len(shz_list)
        z_comms = batch_comms[:nz]
        phi_comms = batch_comms[nz:nz + nphi]
        shz_comms = batch_comms[nz + nphi:nz + nphi + nshz]
        r_comm = batch_comms[-1]
        if ckpt:
            ckpt.save(
                "cols", tr,
                meta=dict(theta=theta, beta=beta, gamma=gamma,
                          challenges=challenges,
                          advice_comms=_pts_meta(advice_comms),
                          m_comms=_pts_meta(m_comms),
                          z_comms=_pts_meta(z_comms),
                          phi_comms=_pts_meta(phi_comms),
                          shz_comms=_pts_meta(shz_comms),
                          r_comm=_pts_meta([r_comm])[0]),
                arrays=dict(advice_l=advice_l, m_all=m_all, z_list=z_list,
                            phi_list=phi_list, shz_list=shz_list,
                            r_evals=r_evals))
    else:
        _span("phase1-4b: resumed from checkpoint", dev)
        meta, arrs = cols_st
        tr._state = bytes.fromhex(meta["transcript_state"])
        theta, beta, gamma = meta["theta"], meta["beta"], meta["gamma"]
        challenges = meta["challenges"]
        theta_dev = limbs.const(FR, theta, device=dev)
        beta_dev = limbs.const(FR, beta, device=dev)
        gamma_dev = limbs.const(FR, gamma, device=dev)
        ch_dev = [limbs.const(FR, v, device=dev) for v in challenges]
        advice_comms = _pts_unmeta(meta["advice_comms"])
        m_comms = _pts_unmeta(meta["m_comms"])
        z_comms = _pts_unmeta(meta["z_comms"])
        phi_comms = _pts_unmeta(meta["phi_comms"])
        shz_comms = _pts_unmeta(meta["shz_comms"])
        r_comm = _pts_unmeta([meta["r_comm"]])[0]
        advice_l = arrs["advice_l"]
        m_all = arrs["m_all"]
        z_list, phi_list = arrs["z_list"], arrs["phi_list"]
        shz_list, r_evals = arrs["shz_list"], arrs["r_evals"]

    h_st = ckpt.load("h", dev) if ckpt else None
    if h_st is None:
        _span("phase5: quotient", dev)
        y = tr.challenge()
        y_dev = limbs.const(FR, y, device=dev)
        h_pieces = kern.stage_quotient(advice_l, fixed_l, instance_l, theta_dev,
                                       beta_dev, gamma_dev, y_dev, z_list,
                                       phi_list, m_all, shz_list, *ch_dev)
        _span("phase5b: commit h", dev)
        h_comms = kzg.commit_many(srs, h_pieces, lagrange=False)
        for cpt in h_comms:
            tr.common_point(cpt)
        if ckpt:
            ckpt.save("h", tr, meta=dict(h_comms=_pts_meta(h_comms)),
                      arrays=dict(h_pieces=h_pieces))
    else:
        _span("phase5: resumed from checkpoint", dev)
        meta_h, arrs_h = h_st
        tr._state = bytes.fromhex(meta_h["transcript_state"])
        h_comms = _pts_unmeta(meta_h["h_comms"])
        h_pieces = arrs_h["h_pieces"]

    _span("phase6: evaluations", dev)
    x = tr.challenge()
    evals: dict[str, int] = {}
    coeff_cache: dict[str, torch.Tensor] = {}
    cols_l = {FIXED: fixed_l, ADVICE: advice_l, INSTANCE: instance_l}

    def coeff_of_col(kind, index):
        key = f"{kind}{index}"
        if key not in coeff_cache:
            coeff_cache[key] = nttmod.intt(FR, cols_l[kind][index])
        return coeff_cache[key]

    queries = cs.all_queries()

    def rot_point(r):
        return dom.rotate_omega(x, r)

    eval_jobs: dict[int, list] = defaultdict(list)  # point -> [(label, coeffs)]
    for q in queries:
        if q.column.kind == INSTANCE:
            continue
        label = _eval_label(q.column.kind, q.column.index, q.rotation)
        eval_jobs[rot_point(q.rotation)].append(
            (label, coeff_of_col(q.column.kind, q.column.index)))
    sigma_coeff = [nttmod.intt(FR, pk.sigma_lagrange[j]) for j in range(m_perm)]
    z_coeff = [nttmod.intt(FR, z) for z in z_list]
    phi_coeff = [nttmod.intt(FR, phi) for phi in phi_list]
    m_coeff = [nttmod.intt(FR, m) for m in m_all]
    shz_coeff = [nttmod.intt(FR, z) for z in shz_list]
    for j in range(m_perm):
        eval_jobs[x].append((f"sigma{j}@0", sigma_coeff[j]))
    for ci in range(len(chunks)):
        eval_jobs[x].append((f"permz{ci}@0", z_coeff[ci]))
        eval_jobs[rot_point(1)].append((f"permz{ci}@1", z_coeff[ci]))
        if ci > 0:
            eval_jobs[rot_point(a)].append((f"permz{ci - 1}@{a}", z_coeff[ci - 1]))
    for li in range(len(cs.lookups)):
        eval_jobs[x].append((f"phi{li}@0", phi_coeff[li]))
        eval_jobs[rot_point(1)].append((f"phi{li}@1", phi_coeff[li]))
        eval_jobs[x].append((f"lkm{li}@0", m_coeff[li]))
    for si in range(len(cs.shuffles)):
        eval_jobs[x].append((f"shz{si}@0", shz_coeff[si]))
        eval_jobs[rot_point(1)].append((f"shz{si}@1", shz_coeff[si]))
    eval_jobs[x].append(("r@0", nttmod.intt(FR, r_evals)))
    for i, piece in enumerate(h_pieces):
        eval_jobs[x].append((f"h{i}@0", piece))

    for point, jobs in eval_jobs.items():
        stack = torch.stack([c for _, c in jobs])
        # pad the poly count to a power of two, as the reference does
        Q = stack.shape[0]
        Qp = 1 << (Q - 1).bit_length()
        if Qp != Q:
            stack = torch.cat([stack, torch.zeros((Qp - Q,) + stack.shape[1:],
                                                  dtype=stack.dtype, device=dev)])
        vals = kern.stage_eval(stack, limbs.const(FR, point, device=dev))[:Q]
        decoded = limbs.decode(FR, vals.movedim(0, 1))
        for (label, _), v in zip(jobs, decoded):
            evals[label] = int(v)

    for label in sorted(evals):
        tr.common_scalar(evals[label])

    _span("phase7: multiopen", dev)
    v_ch = tr.challenge()
    v_dev = limbs.const(FR, v_ch, device=dev)

    groups: dict[int, list] = defaultdict(list)  # point -> [(lagrange, eval_label)]
    for q in queries:
        if q.column.kind == INSTANCE:
            continue
        label = _eval_label(q.column.kind, q.column.index, q.rotation)
        groups[rot_point(q.rotation)].append((cols_l[q.column.kind][q.column.index], label))
    for j in range(m_perm):
        groups[x].append((pk.sigma_lagrange[j], f"sigma{j}@0"))
    for ci in range(len(chunks)):
        groups[x].append((z_list[ci], f"permz{ci}@0"))
        groups[rot_point(1)].append((z_list[ci], f"permz{ci}@1"))
        if ci > 0:
            groups[rot_point(a)].append((z_list[ci - 1], f"permz{ci - 1}@{a}"))
    for li in range(len(cs.lookups)):
        groups[x].append((phi_list[li], f"phi{li}@0"))
        groups[rot_point(1)].append((phi_list[li], f"phi{li}@1"))
        groups[x].append((m_all[li], f"lkm{li}@0"))
    for si in range(len(cs.shuffles)):
        groups[x].append((shz_list[si], f"shz{si}@0"))
        groups[rot_point(1)].append((shz_list[si], f"shz{si}@1"))
    groups[x].append((r_evals, "r@0"))
    for i, piece in enumerate(h_pieces):
        groups[x].append((nttmod.ntt(FR, piece), f"h{i}@0"))

    w_stacks = []
    for point in sorted(groups):
        items = groups[point]
        lag_stack = torch.stack([poly for poly, _ in items])
        ev_stack = torch.stack([limbs.const(FR, evals[label], device=dev) for _, label in items])
        # pad with LEADING zero rows to a power of two, as the reference
        # does (a zero row adds nothing to the running v-RLC)
        Q = lag_stack.shape[0]
        Qp = 1 << (Q - 1).bit_length()
        if Qp != Q:
            lag_stack = torch.cat([torch.zeros((Qp - Q,) + lag_stack.shape[1:],
                                               dtype=lag_stack.dtype, device=dev), lag_stack])
            ev_stack = torch.cat([torch.zeros((Qp - Q,) + ev_stack.shape[1:],
                                              dtype=ev_stack.dtype, device=dev), ev_stack])
        w_stacks.append(kern.stage_open(lag_stack, ev_stack, v_dev,
                                        limbs.const(FR, point, device=dev)))
    opening_comms = kzg.commit_many(srs, w_stacks)
    for cpt in opening_comms:
        tr.common_point(cpt)

    _span("done", dev)
    if ckpt:
        ckpt.clear()
    return Proof(
        advice_commitments=advice_comms,
        lookup_m_commitments=m_comms,
        perm_z_commitments=z_comms,
        lookup_phi_commitments=phi_comms,
        shuffle_z_commitments=shz_comms,
        random_commitment=r_comm,
        h_commitments=h_comms,
        evals=evals,
        opening_commitments=opening_comms,
        instances=[list(c) for c in asg.instance],
    )
