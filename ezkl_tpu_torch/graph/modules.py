"""Hash/commit "coprocessor" modules — the reference's module system
(`ezkl/src/circuit/modules/{poseidon,polycommit}.rs` +
`graph/modules.rs` — SURVEY.md §2.2). Module 0: in-circuit Poseidon.

The Poseidon chip here lays one permutation as 65 chained rows over two
dedicated advice columns with degree-5 round gates (the Pow5 structure):

  full:    q_f * ( sum_k MDS[j][k]*(p_k + rc_k)^5  - p_j(next) ) = 0
  partial: q_p * ( MDS[j][0]*(p_0 + rc_0)^5
                   + MDS[j][1]*(p_1 + rc_1)      - p_j(next) ) = 0

Round constants live in fixed columns; the sponge absorb between
permutations reuses the base `add` gate and copy constraints. The final
state word is copied to the public instance column (hashed visibility).

Port of `ezkl_tpu/graph/modules.py` (pure numpy, copied; imports rewired to the
port's modules).
"""

from __future__ import annotations

import numpy as np

from ..kernels import poseidon as pos
from ..plonk import cs as csmod
from .layout import BaseConfig, LayoutCtx, Span, TVal

P = pos.bn254_fr().modulus


class PoseidonModule:
    """Created on first use; one instance per BaseConfig."""

    def __init__(self, cfg: BaseConfig):
        cs = cfg.cs
        self.cfg = cfg
        self.p0 = cs.advice_column()
        self.p1 = cs.advice_column()
        self.rc0 = cs.fixed_column()
        self.rc1 = cs.fixed_column()
        self.q_full = cs.fixed_column()
        self.q_part = cs.fixed_column()
        for col in (self.p0, self.p1):
            cs.enable_equality(col)
        rc, mds = pos.generate_parameters(P)
        self.rc, self.mds = rc, mds

        v0, v1 = cs.query(self.p0), cs.query(self.p1)
        n0, n1 = cs.query(self.p0, 1), cs.query(self.p1, 1)
        c0, c1 = cs.query(self.rc0), cs.query(self.rc1)
        qf, qp = cs.query(self.q_full), cs.query(self.q_part)

        def pow5(e):
            e2 = e * e
            return e2 * e2 * e

        a0 = v0 + c0
        a1 = v1 + c1
        for j, nxt in ((0, n0), (1, n1)):
            m0 = csmod.Constant(mds[j][0])
            m1 = csmod.Constant(mds[j][1])
            cs.create_gate(f"poseidon_full_{j}",
                           qf * (m0 * pow5(a0) + m1 * pow5(a1) - nxt))
            cs.create_gate(f"poseidon_part_{j}",
                           qp * (m0 * pow5(a0) + m1 * a1 - nxt))

    def hash(self, ctx: LayoutCtx, tv: TVal) -> tuple[int, Span]:
        """Lay the sponge over all elements of tv (flattened, its quantized
        field values). Returns (hash_value_int, span_of_hash_cell).

        Batched: the whole trace comes from ONE specialized host pass
        (`kernels.poseidon.host_sponge_traces`) and every column lands via
        bulk vectorized writes + batched copy constraints — no per-element
        Python layout loop (hashed visibility's hot spot).
        Sponge shape (WIDTH=2/RATE=1, ConstantLength domain) matches the
        reference exactly (`ezkl/src/circuit/modules/poseidon/
        spec.rs:15-17`)."""
        flat = tv.ints.reshape(-1)
        L = int(flat.size)
        assert L >= 1, "poseidon hash of an empty tensor"
        src = ctx.materialize(tv)
        half = pos.FULL_ROUNDS // 2
        rounds = pos.FULL_ROUNDS + pos.PARTIAL_ROUNDS
        blk = rounds + 1

        xs = [int(v) % P for v in flat]
        traces, absorbed = pos.host_sponge_traces(xs, P)

        base = ctx.alloc(L * blk)
        starts = base + blk * np.arange(L)
        ends = starts + rounds
        rows_all = (starts[:, None] + np.arange(blk)[None, :]).reshape(-1)

        # state words: all permutation blocks in one bulk overlay write each
        ctx.write_field_at(self.p0, rows_all, [s[0] for tr in traces for s in tr])
        ctx.write_field_at(self.p1, rows_all, [s[1] for tr in traces for s in tr])
        # round constants tiled per block (rows [start, start+rounds))
        rc_rows = (starts[:, None] + np.arange(rounds)[None, :]).reshape(-1)
        ctx.write_field_at(self.rc0, rc_rows, [self.rc[r][0] for r in range(rounds)] * L)
        ctx.write_field_at(self.rc1, rc_rows, [self.rc[r][1] for r in range(rounds)] * L)
        # selectors: one block-relative mask, applied to all blocks at once
        qf_off = np.concatenate([np.arange(half),
                                 np.arange(half + pos.PARTIAL_ROUNDS, rounds)])
        qp_off = np.arange(half, half + pos.PARTIAL_ROUNDS)
        ctx._arr(self.q_full)[(starts[:, None] + qf_off[None, :]).reshape(-1)] = 1
        ctx._arr(self.q_part)[(starts[:, None] + qp_off[None, :]).reshape(-1)] = 1

        # wire the first block: p0 <- input element 0, p1 <- capacity const
        ctx.copy_rows(self.p0, [starts[0]], src.col, [src.rows[0]])
        capc = TVal(np.zeros(1, np.int64), 0, None)
        cap_span = ctx.materialize(capc)
        ctx.write_field_at(cap_span.col, [int(cap_span.rows[0])], [(L << 64) % P])
        ctx.copy_rows(self.p1, [starts[0]], cap_span.col, [cap_span.rows[0]])

        if L > 1:
            # absorb add rows (a0 = prev s0 out, a1 = x_i, a2 = s0 in), all
            # contiguous: one enable() + four batched copy_rows
            ar = ctx.alloc(L - 1)
            arows = ar + np.arange(L - 1)
            ctx.write_field_at(self.cfg.a0, arows, [tr[-1][0] for tr in traces[:-1]])
            ctx.write(self.cfg.a1, ar, flat[1:])
            ctx.write_field_at(self.cfg.a2, arows, absorbed[1:])
            ctx.enable("add", ar, L - 1)
            ctx.copy_rows(self.cfg.a0, arows, self.p0, ends[:-1])
            ctx.copy_rows(self.cfg.a1, arows, src.col, src.rows[1:])
            ctx.copy_rows(self.cfg.a2, arows, self.p0, starts[1:])
            ctx.copy_rows(self.p1, starts[1:], self.p1, ends[:-1])
        return traces[-1][-1][0], Span(self.p0, np.asarray([ends[-1]]))


def get_poseidon(cfg: BaseConfig) -> PoseidonModule:
    mod = getattr(cfg, "_poseidon", None)
    if mod is None:
        mod = PoseidonModule(cfg)
        cfg._poseidon = mod
    return mod


class FreivaldsModule:
    """Phase-2 einsum/matmul argument (the reference's universal einsum
    Freivalds config, `ezkl/src/circuit/ops/chip/einsum/` —
    SURVEY.md §2.2): instead of M*N*K dot rows, verify C = A*B by checking
    A*(B*r) == C*r with r = powers of a post-commitment challenge.

    Columns: f_v (phase-0 staging of B/C values), cp/acc/f_u/acc2 (phase-1:
    challenge powers, RLC accumulators, staged u values, final dot accs).
    Row cost: K*N + M*N + M*K per matmul instead of M*N*K.
    """

    def __init__(self, cfg: BaseConfig):
        cs = cfg.cs
        self.cfg = cfg
        self.ch = cs.challenge()
        self.f_v = cs.advice_column(phase=0)
        self.cp = cs.advice_column(phase=1)
        self.acc = cs.advice_column(phase=1)
        self.f_u = cs.advice_column(phase=1)
        self.acc2 = cs.advice_column(phase=1)
        for col in (self.f_v, self.cp, self.acc, self.f_u, self.acc2):
            cs.enable_equality(col)
        sel = {}
        for name in ("cp_init", "cp_run", "rlc_init", "rlc_run",
                     "dot2_init", "dot2_run"):
            sel[name] = cs.fixed_column()
        self.sel = sel
        q = {k: cs.query(v) for k, v in sel.items()}
        vv = cs.query(self.f_v)
        vcp, vcp_p = cs.query(self.cp), cs.query(self.cp, -1)
        va, va_p = cs.query(self.acc), cs.query(self.acc, -1)
        vu = cs.query(self.f_u)
        v2, v2_p = cs.query(self.acc2), cs.query(self.acc2, -1)
        one = csmod.Constant(1)
        cs.create_gate("einsum_cp_init", q["cp_init"] * (vcp - one))
        cs.create_gate("einsum_cp_run", q["cp_run"] * (vcp - vcp_p * self.ch))
        cs.create_gate("einsum_rlc_init", q["rlc_init"] * (va - vv * vcp))
        cs.create_gate("einsum_rlc_run", q["rlc_run"] * (va - va_p - vv * vcp))
        cs.create_gate("einsum_dot2_init", q["dot2_init"] * (v2 - vv * vu))
        cs.create_gate("einsum_dot2_run", q["dot2_run"] * (v2 - v2_p - vv * vu))
        # deferred phase-1 witness jobs: (kind, rows..., values...)
        self.jobs: list = []

    # -- layout -------------------------------------------------------------

    def _rlc_region(self, ctx: LayoutCtx, vals: np.ndarray, runs: int,
                    run_len: int, src_span, src_idx: np.ndarray):
        """Lay `runs` RLC runs of length run_len over vals (staged in f_v,
        copied from src). Returns the rows of the final accumulators."""
        L = runs * run_len
        r0 = ctx.alloc(L)
        ctx.write(self.f_v, r0, vals)
        if src_span is not None:
            ctx.copy_rows(self.f_v, r0 + np.arange(L), src_span.col,
                          src_span.rows[src_idx])
        init_mask = np.zeros(L, bool)
        init_mask[np.arange(runs) * run_len] = True
        rows = r0 + np.arange(L)
        ctx._arr(self.sel["cp_init"])[rows[init_mask]] = 1
        ctx._arr(self.sel["cp_run"])[rows[~init_mask]] = 1
        ctx._arr(self.sel["rlc_init"])[rows[init_mask]] = 1
        ctx._arr(self.sel["rlc_run"])[rows[~init_mask]] = 1
        self.jobs.append(("rlc", r0, runs, run_len, vals.copy()))
        return r0 + (np.arange(runs) + 1) * run_len - 1  # final acc rows

    def matmul(self, ctx: LayoutCtx, a, b, out_ints: np.ndarray):
        """Freivalds check for C=A*B. a,b: TVals (M,K),(K,N); out_ints the
        precomputed C (int64). Returns rows of C's staged cells (i-major)
        as the output span in f_v."""
        return self.bmm(ctx, a, b, out_ints[None] if out_ints.ndim == 2
                        else out_ints)

    def bmm(self, ctx: LayoutCtx, a, b, out_ints: np.ndarray,
            shared_b: bool = False):
        """Freivalds check for the batched matmul C[b] = A[b] @ B[b].

        The universal einsum argument (reference
        `ezkl/src/circuit/ops/chip/einsum/mod.rs:104-300`):
        every two-operand einsum reindexes to this shape (see
        `einsum_freivalds`), so one RLC argument covers them all.

        a: TVal with ints (Bt, M, K) — or (M, K), treated as Bt=1.
        b: TVal with ints (Bt, K, N) — or, with shared_b, (K, N) used by
           every batch slice (a broadcast operand is staged and RLC'd ONCE,
           the row saving vs per-slice matmuls).
        out_ints: (Bt, M, N) int64 — the claimed product.

        Check per (t, i): sum_k A[t,i,k] * u[t,k] == v[t,i] where
        u[t,k] = sum_j B[t,k,j] r^j and v[t,i] = sum_j C[t,i,j] r^j with r
        a post-commitment challenge; the (t, i) axes are compared by direct
        copy-equality of the run accumulators (no extra challenge needed).
        Rows: |A| + |B| + |C|. Soundness: Schwartz-Zippel in r, degree N-1.

        Returns the Span of C's staged cells (row-major (Bt, M, N)) in f_v.
        """
        from .layout import Span

        a3 = a.ints if a.ints.ndim == 3 else a.ints[None]
        Bt, M, K = a3.shape
        if shared_b:
            K2, N = b.ints.shape
            u_runs = K
        else:
            b3 = b.ints if b.ints.ndim == 3 else b.ints[None]
            Bt2, K2, N = b3.shape
            assert Bt2 == Bt, f"batch mismatch {Bt2} vs {Bt}"
            u_runs = Bt * K
        assert K2 == K, f"contraction mismatch {K2} vs {K}"
        assert out_ints.shape == (Bt, M, N)
        ctx.materialize(a)
        ctx.materialize(b)

        # B-RLC: rows (t, k, j) -> u_{t,k}  (or (k, j) -> u_k when shared)
        b_flat = b.ints.reshape(-1)
        u_rows = self._rlc_region(ctx, b_flat, u_runs, N, b.span,
                                  np.arange(b_flat.size))

        # C staged + C-RLC: rows (t, i, j) -> v_{t,i}; C's home cells = f_v
        c_flat = out_ints.reshape(-1)
        c_r0 = ctx.alloc(Bt * M * N)
        ctx.write(self.f_v, c_r0, c_flat)
        L = Bt * M * N
        rows = c_r0 + np.arange(L)
        init_mask = np.zeros(L, bool)
        init_mask[np.arange(Bt * M) * N] = True
        for s_init, s_run in (("cp_init", "cp_run"), ("rlc_init", "rlc_run")):
            ctx._arr(self.sel[s_init])[rows[init_mask]] = 1
            ctx._arr(self.sel[s_run])[rows[~init_mask]] = 1
        self.jobs.append(("rlc", c_r0, Bt * M, N, c_flat.copy()))
        v_rows = c_r0 + (np.arange(Bt * M) + 1) * N - 1

        # final dots: rows (t, i, k): f_v = A[t,i,k], f_u = u_{t,k}
        d_r0 = ctx.alloc(Bt * M * K)
        a_flat = a3.reshape(-1)
        ctx.write(self.f_v, d_r0, a_flat)
        ctx.copy_rows(self.f_v, d_r0 + np.arange(Bt * M * K), a.span.col,
                      a.span.rows)
        # u accumulator rows feeding each staged (t, i, k) cell
        if shared_b:
            u_src = np.tile(np.arange(K), Bt * M)
        else:
            u_src = (np.arange(Bt)[:, None, None] * K
                     + np.arange(K)[None, None, :]
                     + np.zeros((1, M, 1), np.int64)).reshape(-1)
        ctx.copy_rows(self.f_u, d_r0 + np.arange(Bt * M * K), self.acc,
                      u_rows[u_src])
        rows = d_r0 + np.arange(Bt * M * K)
        init_mask = np.zeros(Bt * M * K, bool)
        init_mask[np.arange(Bt * M) * K] = True
        ctx._arr(self.sel["dot2_init"])[rows[init_mask]] = 1
        ctx._arr(self.sel["dot2_run"])[rows[~init_mask]] = 1
        self.jobs.append(("dot2", d_r0, Bt * M, K, a_flat.copy(),
                          u_rows[u_src].reshape(Bt * M, K).copy()))
        dot_final = d_r0 + (np.arange(Bt * M) + 1) * K - 1
        # equality: acc2 final == v_{t,i}
        ctx.copy_rows(self.acc2, dot_final, self.acc, v_rows)

        return Span(self.f_v, c_r0 + np.arange(Bt * M * N))

    # -- phase-1 witness ----------------------------------------------------

    def make_callback(self, n: int):
        jobs = self.jobs
        ch_index = self.ch.index
        cols = dict(cp=self.cp.index, acc=self.acc.index,
                    f_u=self.f_u.index, acc2=self.acc2.index)

        def callback(challenges: dict[int, int]) -> dict:
            # Fully numpy-vectorized object-bigint math (a Python loop per
            # run with per-element `pow` costs minutes of host time
            # mid-prove at attention scale).
            # Keys: (a) challenge powers by doubling ladder, shared across
            # runs; (b) one broadcast multiply + np.add.accumulate per job
            # — partial sums stay < runs_len * P (~2^264), so a single
            # trailing % P suffices; (c) u-values gathered by fancy index
            # from a row-indexed array, no dict lookups in the hot path.
            c = challenges[ch_index] % P
            cp_col = np.zeros(n, object)
            acc_col = np.zeros(n, object)
            fu_col = np.zeros(n, object)
            acc2_col = np.zeros(n, object)
            u_by_row = np.zeros(n, object)   # final-acc row -> RLC value

            pow_cache: dict[int, np.ndarray] = {}

            def cpowers(rl: int) -> np.ndarray:
                got = pow_cache.get(rl)
                if got is None:
                    got = np.array([1], object)
                    while len(got) < rl:
                        m = len(got)
                        got = np.concatenate([got, (got * pow(c, m, P)) % P])
                    got = got[:rl]
                    pow_cache[rl] = got
                return got

            for job in jobs:
                if job[0] == "rlc":
                    _, r0, runs, rl, vals = job
                    cps = cpowers(rl)
                    V = (np.asarray(vals, object).reshape(runs, rl)) % P
                    terms = (V * cps[None, :]) % P
                    accs = np.add.accumulate(terms, axis=1) % P
                    rows = slice(r0, r0 + runs * rl)
                    cp_col[rows] = np.broadcast_to(cps, (runs, rl)).reshape(-1)
                    acc_col[rows] = accs.reshape(-1)
                    u_by_row[r0 + (np.arange(runs) + 1) * rl - 1] = accs[:, -1]
            for job in jobs:
                if job[0] == "dot2":
                    _, r0, M, K, a_vals, u_rows = job
                    # u_rows: (M, K) acc rows feeding each run's f_u cells
                    u_vals = u_by_row[np.asarray(u_rows, np.int64)]  # (M, K)
                    A = (np.asarray(a_vals, object).reshape(M, K)) % P
                    terms = (A * u_vals) % P
                    accs = np.add.accumulate(terms, axis=1) % P
                    rows = slice(r0, r0 + M * K)
                    fu_col[rows] = u_vals.reshape(-1)
                    acc2_col[rows] = accs.reshape(-1)
            return {cols["cp"]: cp_col.tolist(),
                    cols["acc"]: acc_col.tolist(),
                    cols["f_u"]: fu_col.tolist(),
                    cols["acc2"]: acc2_col.tolist()}

        return callback


def get_freivalds(cfg: BaseConfig) -> FreivaldsModule:
    mod = getattr(cfg, "_freivalds", None)
    if mod is None:
        mod = FreivaldsModule(cfg)
        cfg._freivalds = mod
    return mod
