"""Host-side proof verification (transcript replay + 2-pairing KZG check);
a copy of `ezkl_tpu/plonk/verifier.py` on the port's own modules.

Analog of `verify_proof_circuit` -> halo2 `verify_proof`
(SURVEY.md §3.5, `ezkl/src/pfsys/mod.rs:557-590`). Pure Python
bigints + the host pairing — verification is milliseconds, no device needed.
"""

from __future__ import annotations

from collections import defaultdict

from ..fieldmath import hostcurve as hc
from ..fieldmath.spec import bn254_fr
from ..kernels import ntt as nttmod
from . import pairing
from .cs import ConstraintSystem, FIXED, ADVICE, INSTANCE
from .cs import last_active_row
from .evaluator import evaluate_at_point
from .keygen import VerifyingKey, DELTA
from .prover import Proof, _eval_label
from .transcript import Transcript

FR = bn254_fr()
P = FR.modulus


def _lagrange_eval_host(values: list[int], z: int, k: int) -> int:
    """P(z) for the poly with evals `values` (padded 0) over H."""
    n = 1 << k
    w = nttmod.root_of_unity(FR, k)
    znm1 = (pow(z, n, P) - 1) % P
    ninv = pow(n, -1, P)
    total = 0
    wi = 1
    for i in range(n):
        if i < len(values) and values[i]:
            total += values[i] * wi % P * pow((z - wi) % P, -1, P) % P
        wi = wi * w % P
    return total * znm1 % P * ninv % P


def _l_basis_host(i: int, z: int, k: int) -> int:
    """l_i(z) over H."""
    n = 1 << k
    w = nttmod.root_of_unity(FR, k)
    wi = pow(w, i, P)
    znm1 = (pow(z, n, P) - 1) % P
    return znm1 * wi % P * pow(n * (z - wi) % P, -1, P) % P


def _validate_proof(proof: Proof) -> bool:
    """Reject invalid-curve / non-canonical proof elements before any group
    arithmetic: every G1 point must be on y^2 = x^3 + 3 with coordinates in
    [0, q) (BN254 G1 has cofactor 1 so the on-curve check suffices), every
    scalar in [0, r). Mirrors halo2's deserialization curve checks."""
    pts = (proof.advice_commitments + proof.lookup_m_commitments
           + proof.perm_z_commitments + proof.lookup_phi_commitments
           + proof.shuffle_z_commitments + [proof.random_commitment]
           + proof.h_commitments + proof.opening_commitments)
    for pt in pts:
        if pt is None:
            continue
        x, y = pt
        if not (0 <= x < hc.P and 0 <= y < hc.P):
            return False
        if not hc.g1_is_on_curve(pt):
            return False
    for v in proof.evals.values():
        if not (0 <= v < P):
            return False
    for col in proof.instances:
        for v in col:
            if not (0 <= v < P):
                return False
    return True


def verify(vk: VerifyingKey, g2, s_g2, proof: Proof,
           transcript: Transcript | None = None) -> bool:
    red = verify_reduced(vk, proof, transcript)
    if not red:
        return False
    lhs, rhs = red
    return pairing.pairing_check([
        (lhs, s_g2),
        (hc.g1_neg(rhs) if rhs else None, g2),
    ])


def verify_reduced(vk: VerifyingKey, proof: Proof,
                   transcript: Transcript | None = None):
    """All verifier checks EXCEPT the final pairing.

    Returns None if any scalar-side identity or transcript check fails;
    otherwise (lhs, rhs) G1 points such that the proof is valid iff
    e(lhs, [s]_2) == e(rhs, [1]_2). Splitting here is what makes N-proof
    aggregation possible: RLC-combine the (lhs, rhs) pairs and run ONE
    pairing for the whole batch (`plonk/aggregate.py`; the reference gets
    the same verifier-cost collapse through its aggregation circuit,
    `ezkl/src/execute.rs` aggregate + snark-verifier)."""
    cs = vk.cs
    k = vk.k
    n = 1 << k
    dom = vk.domain
    tr = transcript or Transcript()

    if not _validate_proof(proof):
        return False

    # ---- transcript replay
    tr.common_bytes(vk.transcript_repr())
    for col in proof.instances:
        for v in col:
            tr.common_scalar(v)
    phases = cs.advice_phase
    for i, c in enumerate(proof.advice_commitments):
        if phases[i] == 0:
            tr.common_point(c)
    challenges = {i: tr.challenge() for i in range(cs.num_challenges)}
    for i, c in enumerate(proof.advice_commitments):
        if phases[i] != 0:
            tr.common_point(c)
    theta = tr.challenge()
    for c in proof.lookup_m_commitments:
        tr.common_point(c)
    beta = tr.challenge()
    gamma = tr.challenge()
    for c in proof.perm_z_commitments:
        tr.common_point(c)
    for c in proof.lookup_phi_commitments:
        tr.common_point(c)
    for c in proof.shuffle_z_commitments:
        tr.common_point(c)
    tr.common_point(proof.random_commitment)
    y = tr.challenge()
    for c in proof.h_commitments:
        tr.common_point(c)
    x = tr.challenge()
    for label in sorted(proof.evals):
        tr.common_scalar(proof.evals[label])
    v_ch = tr.challenge()
    for c in proof.opening_commitments:
        tr.common_point(c)
    u_ch = tr.challenge()

    def rot_point(r):
        return dom.rotate_omega(x, r)

    # ---- query values (instance evals computed from public values)
    qv = dict()
    queries = cs.all_queries()
    for q in queries:
        key = (q.column.kind, q.column.index, q.rotation)
        if q.column.kind == INSTANCE:
            qv[key] = _lagrange_eval_host(
                proof.instances[q.column.index], rot_point(q.rotation), k)
        else:
            qv[key] = proof.evals[_eval_label(*key)]

    # ---- gate + argument total at x
    total = 0

    def acc(term):
        nonlocal total
        total = (total * y + term) % P

    for g in cs.gates:
        acc(evaluate_at_point(g.poly, qv, challenges))

    a = last_active_row(n)
    l0 = _l_basis_host(0, x, k)
    llast = _l_basis_host(a, x, k)       # closing-row basis
    blind_sum = llast
    for i in range(a + 1, n):
        blind_sum = (blind_sum + _l_basis_host(i, x, k)) % P
    not_last = (1 - blind_sum) % P       # active-rows mask

    m_perm = len(cs.perm_columns)
    chunk = cs.perm_chunk_size()
    chunks = [list(range(i, min(i + chunk, m_perm))) for i in range(0, m_perm, chunk)] if chunk else []

    for ci, cset in enumerate(chunks):
        z_x = proof.evals[f"permz{ci}@0"]
        z_wx = proof.evals[f"permz{ci}@1"]
        num = den = 1
        for j in cset:
            c = cs.perm_columns[j]
            v = qv[(c.kind, c.index, 0)]
            idj = pow(DELTA, j, P) * x % P
            num = num * ((v + beta * idj + gamma) % P) % P
            sig = proof.evals[f"sigma{j}@0"]
            den = den * ((v + beta * sig + gamma) % P) % P
        acc(not_last * ((z_wx * den - z_x * num) % P) % P)
        if ci == 0:
            acc(l0 * (z_x - 1) % P)
        else:
            prev = proof.evals[f"permz{ci - 1}@{a}"]
            acc(l0 * (z_x - prev) % P)
        if ci == len(chunks) - 1:
            acc(llast * (z_x - 1) % P)

    for li, lk in enumerate(cs.lookups):
        phi_x = proof.evals[f"phi{li}@0"]
        phi_wx = proof.evals[f"phi{li}@1"]
        m_x = proof.evals[f"lkm{li}@0"]

        def compress(tup):
            a = 0
            for e in tup:
                a = (a * theta + evaluate_at_point(e, qv, challenges)) % P
            return a

        f_pbs = [(compress(tup) + beta) % P for tup in lk.inputs]
        t_pb = (compress(lk.table) + beta) % P
        prod_f = 1
        for fpb in f_pbs:
            prod_f = prod_f * fpb % P
        if len(f_pbs) == 1:
            sum_except = 1
        else:
            sum_except = 0
            for kk in range(len(f_pbs)):
                pr = 1
                for jj, fpb in enumerate(f_pbs):
                    if jj != kk:
                        pr = pr * fpb % P
                sum_except = (sum_except + pr) % P
        running = ((phi_wx - phi_x) * prod_f % P * t_pb - (t_pb * sum_except - m_x * prod_f)) % P
        acc(not_last * running % P)
        acc(l0 * phi_x % P)
        acc(llast * phi_x % P)

    for si, sh in enumerate(cs.shuffles):
        z_x = proof.evals[f"shz{si}@0"]
        z_wx = proof.evals[f"shz{si}@1"]

        def compress(tup):
            a = 0
            for e in tup:
                a = (a * theta + evaluate_at_point(e, qv, challenges)) % P
            return a

        a_x = (compress(sh.input) + gamma) % P
        b_x = (compress(sh.table) + gamma) % P
        acc(not_last * ((z_wx * b_x - z_x * a_x) % P) % P)
        acc(l0 * (z_x - 1) % P)
        acc(llast * (z_x - 1) % P)

    # ---- quotient identity at x
    zh_x = (pow(x, n, P) - 1) % P
    h_x = 0
    xn = pow(x, n, P)
    for i in range(len(proof.h_commitments) - 1, -1, -1):
        h_x = (h_x * xn + proof.evals[f"h{i}@0"]) % P
    if total != zh_x * h_x % P:
        return False

    # ---- KZG multiopen check (GWC), mirroring prover's grouping
    groups = defaultdict(list)  # point -> [(commitment, eval)]

    def commitment_of(kind, index):
        if kind == ADVICE:
            return proof.advice_commitments[index]
        if kind == FIXED:
            return vk.fixed_commitments[index]
        raise KeyError(kind)

    for q in queries:
        if q.column.kind == INSTANCE:
            continue
        key = (q.column.kind, q.column.index, q.rotation)
        groups[rot_point(q.rotation)].append(
            (commitment_of(q.column.kind, q.column.index), qv[key]))
    for j in range(m_perm):
        groups[x].append((vk.sigma_commitments[j], proof.evals[f"sigma{j}@0"]))
    for ci in range(len(chunks)):
        groups[x].append((proof.perm_z_commitments[ci], proof.evals[f"permz{ci}@0"]))
        groups[rot_point(1)].append((proof.perm_z_commitments[ci], proof.evals[f"permz{ci}@1"]))
        if ci > 0:
            groups[rot_point(a)].append(
                (proof.perm_z_commitments[ci - 1], proof.evals[f"permz{ci - 1}@{a}"]))
    for li in range(len(cs.lookups)):
        groups[x].append((proof.lookup_phi_commitments[li], proof.evals[f"phi{li}@0"]))
        groups[rot_point(1)].append((proof.lookup_phi_commitments[li], proof.evals[f"phi{li}@1"]))
        groups[x].append((proof.lookup_m_commitments[li], proof.evals[f"lkm{li}@0"]))
    for si in range(len(cs.shuffles)):
        groups[x].append((proof.shuffle_z_commitments[si], proof.evals[f"shz{si}@0"]))
        groups[rot_point(1)].append((proof.shuffle_z_commitments[si], proof.evals[f"shz{si}@1"]))
    groups[x].append((proof.random_commitment, proof.evals["r@0"]))
    for i in range(len(proof.h_commitments)):
        groups[x].append((proof.h_commitments[i], proof.evals[f"h{i}@0"]))

    points_sorted = sorted(groups)
    if len(points_sorted) != len(proof.opening_commitments):
        return False

    # e(sum u^j W_j, [s]_2) == e(sum u^j (z_j W_j + C_j - v_j G), [1]_2)
    lhs = None
    rhs = None
    upow = 1
    for point, w_comm in zip(points_sorted, proof.opening_commitments):
        c_comb = None
        v_comb = 0
        for comm, ev in groups[point]:
            c_comb = hc.g1_add(hc.g1_mul(c_comb, v_ch) if c_comb else None, comm)
            v_comb = (v_comb * v_ch + ev) % P
        term_r = hc.g1_add(hc.g1_add(hc.g1_mul(w_comm, point), c_comb),
                           hc.g1_neg(hc.g1_mul(hc.G1, v_comb)))
        lhs = hc.g1_add(lhs, hc.g1_mul(w_comm, upow))
        rhs = hc.g1_add(rhs, hc.g1_mul(term_r, upow))
        upow = upow * u_ch % P
    return lhs, rhs
