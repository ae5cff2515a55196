"""The benchmark's reference verifier of a proof, in plain Python integers.

It replays the proof's Fiat-Shamir transcript (blake2b, the default
transcript of the proof format), checks that the gates, the permutation,
the log-derivative lookups and the shuffles hold at the challenge x
against the quotient's pieces, and checks every opening of the GWC
multi-open. The last check is made with the SRS's secret tau, which the
benchmark chose itself: e(L, [tau]G2) = e(R, G2) holds exactly when
[tau]L = R in G1, so no pairing is needed.

What it takes from the program is what it judges: the proof (as its JSON
text) and the keyed circuit (`circuit_of` reads the constraint system and
the verifying key's commitments). The protocol's constants (the blinding
rows, the permutation's chunk size, delta, the transcript's labels) are
written out here, as the proof format fixes them.
"""

from __future__ import annotations

import hashlib
import json
from collections import defaultdict

from . import bn254
from .bn254 import R

BLINDING_ROWS = 6               # rows n - 6 .. n - 1 hold blinding values
PERM_CHUNK = 6                  # permutation columns per grand product
DELTA = pow(bn254.FR_GENERATOR, 1 << bn254.FR_TWO_ADICITY, R)
TRANSCRIPT_LABEL = b"ezkl-tpu-proof"


# ---------------------------------------------------------------------------
# the keyed circuit, as plain data
# ---------------------------------------------------------------------------

def _expr(e):
    kind = type(e).__name__
    if kind == "Constant":
        return ("const", e.value % R)
    if kind == "Var":
        q = e.query
        return ("var", q.column.kind, q.column.index, q.rotation)
    if kind == "Challenge":
        return ("chal", e.index)
    if kind in ("Sum", "Product"):
        return (kind.lower(), _expr(e.a), _expr(e.b))
    if kind == "Scaled":
        return ("scaled", _expr(e.a), e.k % R)
    raise TypeError(f"unknown expression node {kind}")


def circuit_of(vk) -> dict:
    """The verifying key `vk` of the program as plain data."""
    cs = vk.cs
    return {
        "k": vk.k,
        "num_fixed": cs.num_fixed, "num_advice": cs.num_advice,
        "num_instance": cs.num_instance,
        "advice_phase": list(cs.advice_phase), "num_challenges": cs.num_challenges,
        "gates": [_expr(g.poly) for g in cs.gates],
        "lookups": [([tuple(_expr(e) for e in tup) for tup in lk.inputs],
                     tuple(_expr(e) for e in lk.table)) for lk in cs.lookups],
        "shuffles": [(tuple(_expr(e) for e in sh.input), tuple(_expr(e) for e in sh.table))
                     for sh in cs.shuffles],
        "perm_columns": [(c.kind, c.index) for c in cs.perm_columns],
        "fixed_commitments": list(vk.fixed_commitments),
        "sigma_commitments": list(vk.sigma_commitments),
    }


def _queries(e, out):
    tag = e[0]
    if tag == "var":
        out.append(e[1:])
    elif tag in ("sum", "product"):
        _queries(e[1], out)
        _queries(e[2], out)
    elif tag == "scaled":
        _queries(e[1], out)


def all_queries(c: dict) -> list:
    """Every (kind, index, rotation) the circuit queries, once, sorted."""
    out = []
    for g in c["gates"]:
        _queries(g, out)
    for inputs, table in c["lookups"]:
        for tup in inputs:
            for e in tup:
                _queries(e, out)
        for e in table:
            _queries(e, out)
    for a, b in c["shuffles"]:
        for e in a + b:
            _queries(e, out)
    out += [(kind, index, 0) for kind, index in c["perm_columns"]]
    return sorted(set(out))


def _eval(e, qv, ch):
    tag = e[0]
    if tag == "const":
        return e[1]
    if tag == "var":
        return qv[e[1:]]
    if tag == "chal":
        return ch[e[1]]
    if tag == "sum":
        return (_eval(e[1], qv, ch) + _eval(e[2], qv, ch)) % R
    if tag == "product":
        return _eval(e[1], qv, ch) * _eval(e[2], qv, ch) % R
    return _eval(e[1], qv, ch) * e[2] % R


def _transcript_repr(c: dict) -> bytes:
    h = hashlib.blake2b(digest_size=32)
    h.update(f"k={c['k']};nf={c['num_fixed']};na={c['num_advice']};"
             f"ni={c['num_instance']};g={len(c['gates'])};"
             f"lk={len(c['lookups'])};sh={len(c['shuffles'])}".encode())
    for pt in c["fixed_commitments"] + c["sigma_commitments"]:
        h.update(b"\x00" * 64 if pt is None else
                 pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little"))
    return h.digest()


class _Transcript:
    def __init__(self):
        self.state = hashlib.blake2b(TRANSCRIPT_LABEL, digest_size=64).digest()

    def absorb(self, data: bytes):
        self.state = hashlib.blake2b(self.state + b"\x01" + data, digest_size=64).digest()

    def scalar(self, v: int):
        self.absorb((v % R).to_bytes(32, "little"))

    def point(self, p):
        self.absorb(b"\x00" * 64 if p is None else
                    p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little"))

    def challenge(self) -> int:
        out = hashlib.blake2b(self.state + b"\x00", digest_size=64).digest()
        self.state = hashlib.blake2b(self.state + b"\x02" + out, digest_size=64).digest()
        return int.from_bytes(out, "little") % R


# ---------------------------------------------------------------------------
# the proof
# ---------------------------------------------------------------------------

def parse_proof(text: str) -> dict:
    d = json.loads(text)

    def pt(p):
        return None if p is None else (int(p[0], 16), int(p[1], 16))

    return {
        "advice": [pt(p) for p in d["advice"]],
        "lookup_m": [pt(p) for p in d["lookup_m"]],
        "perm_z": [pt(p) for p in d["perm_z"]],
        "lookup_phi": [pt(p) for p in d["lookup_phi"]],
        "shuffle_z": [pt(p) for p in d.get("shuffle_z", [])],
        "random": pt(d["random"]),
        "h": [pt(p) for p in d["h"]],
        "evals": {k: int(v, 16) for k, v in d["evals"].items()},
        "openings": [pt(p) for p in d["openings"]],
        "instances": [[int(v, 16) for v in col] for col in d["instances"]],
    }


def _lagrange_eval(values, z: int, k: int) -> int:
    """P(z) for the polynomial whose values over H are `values` (then 0)."""
    n = 1 << k
    w = bn254.root_of_unity(k)
    total, wi = 0, 1
    for v in values:
        if v:
            total += v * wi % R * pow((z - wi) % R, -1, R)
        wi = wi * w % R
    return total % R * (pow(z, n, R) - 1) % R * pow(n, -1, R) % R


def _l_basis(i: int, z: int, k: int) -> int:
    n = 1 << k
    wi = pow(bn254.root_of_unity(k), i, R)
    return (pow(z, n, R) - 1) * wi % R * pow(n * (z - wi) % R, -1, R) % R


def verify(c: dict, proof: dict, tau: int) -> bool:
    """Whether `proof` proves the circuit `c` with an SRS of secret `tau`."""
    k = c["k"]
    n = 1 << k
    pts = (proof["advice"] + proof["lookup_m"] + proof["perm_z"] + proof["lookup_phi"]
           + proof["shuffle_z"] + [proof["random"]] + proof["h"] + proof["openings"])
    if not all(bn254.on_curve(p) for p in pts):
        return False
    if not all(0 <= v < R for v in list(proof["evals"].values())
               + [v for col in proof["instances"] for v in col]):
        return False

    tr = _Transcript()
    tr.absorb(_transcript_repr(c))
    for col in proof["instances"]:
        for v in col:
            tr.scalar(v)
    phases = c["advice_phase"]
    if len(proof["advice"]) != len(phases):
        return False
    for ph, p in zip(phases, proof["advice"]):
        if ph == 0:
            tr.point(p)
    ch = {i: tr.challenge() for i in range(c["num_challenges"])}
    for ph, p in zip(phases, proof["advice"]):
        if ph != 0:
            tr.point(p)
    theta = tr.challenge()
    for p in proof["lookup_m"]:
        tr.point(p)
    beta = tr.challenge()
    gamma = tr.challenge()
    for p in proof["perm_z"] + proof["lookup_phi"] + proof["shuffle_z"] + [proof["random"]]:
        tr.point(p)
    y = tr.challenge()
    for p in proof["h"]:
        tr.point(p)
    x = tr.challenge()
    ev = proof["evals"]
    for label in sorted(ev):
        tr.scalar(ev[label])
    v_ch = tr.challenge()
    for p in proof["openings"]:
        tr.point(p)
    u_ch = tr.challenge()

    w = bn254.root_of_unity(k)
    w_inv = pow(w, -1, R)

    def rot(r):
        return x * pow(w if r >= 0 else w_inv, abs(r), R) % R

    queries = all_queries(c)
    qv = {}
    for key in queries:
        kind, index, rotation = key
        if kind == "instance":
            qv[key] = _lagrange_eval(proof["instances"][index], rot(rotation), k)
        else:
            qv[key] = ev[f"{kind}{index}@{rotation}"]

    total = 0

    def acc(term):
        nonlocal total
        total = (total * y + term) % R

    for g in c["gates"]:
        acc(_eval(g, qv, ch))
    a = n - BLINDING_ROWS - 1
    l0 = _l_basis(0, x, k)
    llast = _l_basis(a, x, k)
    blind = sum(_l_basis(i, x, k) for i in range(a, n)) % R
    not_last = (1 - blind) % R

    perm = c["perm_columns"]
    chunks = [list(range(i, min(i + PERM_CHUNK, len(perm))))
              for i in range(0, len(perm), PERM_CHUNK)]
    for ci, cset in enumerate(chunks):
        z_x, z_wx = ev[f"permz{ci}@0"], ev[f"permz{ci}@1"]
        num = den = 1
        for j in cset:
            v = qv[(perm[j][0], perm[j][1], 0)]
            num = num * (v + beta * pow(DELTA, j, R) * x + gamma) % R
            den = den * (v + beta * ev[f"sigma{j}@0"] + gamma) % R
        acc(not_last * (z_wx * den - z_x * num) % R)
        prev = 1 if ci == 0 else ev[f"permz{ci - 1}@{a}"]
        acc(l0 * (z_x - prev) % R)
        if ci == len(chunks) - 1:
            acc(llast * (z_x - 1) % R)

    def compress(tup):
        out = 0
        for e in tup:
            out = (out * theta + _eval(e, qv, ch)) % R
        return out

    for li, (inputs, table) in enumerate(c["lookups"]):
        phi_x, phi_wx, m_x = ev[f"phi{li}@0"], ev[f"phi{li}@1"], ev[f"lkm{li}@0"]
        f = [(compress(tup) + beta) % R for tup in inputs]
        t = (compress(table) + beta) % R
        prod_f = 1
        for fi in f:
            prod_f = prod_f * fi % R
        sum_except = 1 if len(f) == 1 else 0
        if len(f) > 1:
            for skip in range(len(f)):
                part = 1
                for j, fj in enumerate(f):
                    if j != skip:
                        part = part * fj % R
                sum_except += part
        running = ((phi_wx - phi_x) * prod_f * t - (t * sum_except - m_x * prod_f)) % R
        acc(not_last * running % R)
        acc(l0 * phi_x % R)
        acc(llast * phi_x % R)

    for si, (a_in, b_tab) in enumerate(c["shuffles"]):
        z_x, z_wx = ev[f"shz{si}@0"], ev[f"shz{si}@1"]
        acc(not_last * (z_wx * (compress(b_tab) + gamma) - z_x * (compress(a_in) + gamma)) % R)
        acc(l0 * (z_x - 1) % R)
        acc(llast * (z_x - 1) % R)

    xn = pow(x, n, R)
    h_x = 0
    for i in reversed(range(len(proof["h"]))):
        h_x = (h_x * xn + ev[f"h{i}@0"]) % R
    if total != (xn - 1) * h_x % R:
        return False

    groups = defaultdict(list)          # point -> [(commitment, value)]
    for key in queries:
        kind, index, rotation = key
        if kind == "instance":
            continue
        comm = proof["advice"][index] if kind == "advice" else c["fixed_commitments"][index]
        groups[rot(rotation)].append((comm, qv[key]))
    for j in range(len(perm)):
        groups[x].append((c["sigma_commitments"][j], ev[f"sigma{j}@0"]))
    for ci in range(len(chunks)):
        groups[x].append((proof["perm_z"][ci], ev[f"permz{ci}@0"]))
        groups[rot(1)].append((proof["perm_z"][ci], ev[f"permz{ci}@1"]))
        if ci > 0:
            groups[rot(a)].append((proof["perm_z"][ci - 1], ev[f"permz{ci - 1}@{a}"]))
    for li in range(len(c["lookups"])):
        groups[x].append((proof["lookup_phi"][li], ev[f"phi{li}@0"]))
        groups[rot(1)].append((proof["lookup_phi"][li], ev[f"phi{li}@1"]))
        groups[x].append((proof["lookup_m"][li], ev[f"lkm{li}@0"]))
    for si in range(len(c["shuffles"])):
        groups[x].append((proof["shuffle_z"][si], ev[f"shz{si}@0"]))
        groups[rot(1)].append((proof["shuffle_z"][si], ev[f"shz{si}@1"]))
    groups[x].append((proof["random"], ev["r@0"]))
    for i, p in enumerate(proof["h"]):
        groups[x].append((p, ev[f"h{i}@0"]))
    points = sorted(groups)
    if len(points) != len(proof["openings"]):
        return False

    # KZG: for each point z_j with witness W_j and the v-combined commitment
    # C_j and value v_j, [tau - z_j] W_j = C_j - [v_j] G; all at once with
    # the weights u^j
    terms, uj = [], 1
    for point, w_comm in zip(points, proof["openings"]):
        c_pow, v_comb = 1, 0
        for comm, val in reversed(groups[point]):
            terms.append((comm, -uj * c_pow))
            c_pow = c_pow * v_ch % R
        for _, val in groups[point]:
            v_comb = (v_comb * v_ch + val) % R
        terms.append((w_comm, uj * (tau - point)))
        terms.append((bn254.G1, uj * v_comb))
        uj = uj * u_ch % R
    return bn254.lincomb(terms) is None
