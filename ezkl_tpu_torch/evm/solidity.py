"""Solidity verifier generator for the ezkl_tpu protocol (copy of
`ezkl_tpu/evm/solidity.py`: for one verifying key both packages write the
same text byte for byte, the header comments that name the generator
included).

Counterpart of the reference's `halo2_solidity_verifier` + `create-evm-verifier`
(`ezkl/src/execute.rs:1306-1530`, `src/eth.rs:162-377`). Because
this engine uses its own protocol (own transcript, GWC multiopen — see
README "protocol scope"), the generated contract implements OUR verifier
(`plonk/verifier.py`) rather than halo2's:

* EvmTranscript replay (keccak256 chaining, 32-byte big-endian encodings —
  `plonk/transcript.py:EvmTranscript`); proofs intended for EVM
  verification must be created with that transcript.
* gate / permutation / lookup(logup) / shuffle identities evaluated at x,
  with gate expressions compiled to mulmod/addmod Solidity code.
* GWC multiopen reduced to one 2-pair check on the pairing precompile.

Proof bytes follow `api.encode_evm_calldata`'s layout exactly.

The expression codegen is validated by rendering the same tree to Python
and checking it against `evaluate_at_point` (tests/test_torch_evm.py); the
contract's logic runs on the in-repo EVM as the bytecode twin
(`evm/bytecode.py`, `evm/vm.py`).
"""

from __future__ import annotations

from collections import defaultdict

from ..fieldmath.spec import FR_MODULUS, FQ_MODULUS, bn254_fr
from ..kernels.ntt import root_of_unity
from ..plonk.cs import (Challenge, Constant, Product, Scaled, Sum, Var,
                        ADVICE, FIXED, INSTANCE, last_active_row,
                        BLINDING_FACTORS)
from ..plonk.keygen import VerifyingKey, DELTA
from ..plonk.prover import _eval_label


# ---------------------------------------------------------------------------
# expression codegen (dual target: Solidity and Python — the Python render
# is the test oracle for the Solidity render, same tree walk)
# ---------------------------------------------------------------------------

def expr_code(expr, var_ref, ch_ref, lang: str = "sol") -> str:
    """Render an Expr tree as nested mulmod/addmod code.

    var_ref(kind, index, rotation) / ch_ref(index) -> operand code string.
    lang "sol" and "py" emit the identical structure; in Python, `mulmod`/
    `addmod` are defined as lambdas in the eval namespace."""
    R = "R" if lang == "sol" else "R"
    if isinstance(expr, Constant):
        return hex(expr.value % FR_MODULUS)
    if isinstance(expr, Var):
        q = expr.query
        return var_ref(q.column.kind, q.column.index, q.rotation)
    if isinstance(expr, Challenge):
        return ch_ref(expr.index)
    if isinstance(expr, Sum):
        return (f"addmod({expr_code(expr.a, var_ref, ch_ref, lang)}, "
                f"{expr_code(expr.b, var_ref, ch_ref, lang)}, {R})")
    if isinstance(expr, Product):
        return (f"mulmod({expr_code(expr.a, var_ref, ch_ref, lang)}, "
                f"{expr_code(expr.b, var_ref, ch_ref, lang)}, {R})")
    if isinstance(expr, Scaled):
        return (f"mulmod({expr_code(expr.a, var_ref, ch_ref, lang)}, "
                f"{hex(expr.k % FR_MODULUS)}, {R})")
    raise TypeError(f"unknown expr node {type(expr)}")


# ---------------------------------------------------------------------------
# structural mirrors of prover/verifier enumeration
# ---------------------------------------------------------------------------

def perm_chunks(cs):
    m_perm = len(cs.perm_columns)
    chunk = cs.perm_chunk_size()
    return [list(range(i, min(i + chunk, m_perm)))
            for i in range(0, m_perm, chunk)] if chunk else []


def eval_label_list(vk: VerifyingKey) -> list[str]:
    """The exact sorted eval-label list the prover emits (prover.py
    phase6); proof bytes carry evals in this order."""
    cs = vk.cs
    a = last_active_row(1 << vk.k)
    chunks = perm_chunks(cs)
    nh = vk.domain.n_ext // vk.domain.n
    labels = set()
    for q in cs.all_queries():
        if q.column.kind == INSTANCE:
            continue
        labels.add(_eval_label(q.column.kind, q.column.index, q.rotation))
    for j in range(len(cs.perm_columns)):
        labels.add(f"sigma{j}@0")
    for ci in range(len(chunks)):
        labels.add(f"permz{ci}@0")
        labels.add(f"permz{ci}@1")
        if ci > 0:
            labels.add(f"permz{ci - 1}@{a}")
    for li in range(len(cs.lookups)):
        labels.add(f"phi{li}@0")
        labels.add(f"phi{li}@1")
        labels.add(f"lkm{li}@0")
    for si in range(len(cs.shuffles)):
        labels.add(f"shz{si}@0")
        labels.add(f"shz{si}@1")
    labels.add("r@0")
    for i in range(nh):
        labels.add(f"h{i}@0")
    return sorted(labels)


def opening_groups(vk: VerifyingKey):
    """rotation -> ordered [(commitment_source, eval_label)] exactly as the
    prover groups the multiopen (prover.py phase7). Sources:
    ("adv",i) ("fix",i) ("sigma",j) ("permz",ci) ("phi",li) ("m",li)
    ("shz",si) ("rand",) ("h",i)."""
    cs = vk.cs
    a = last_active_row(1 << vk.k)
    chunks = perm_chunks(cs)
    nh = vk.domain.n_ext // vk.domain.n
    groups: dict[int, list] = defaultdict(list)
    for q in cs.all_queries():
        if q.column.kind == INSTANCE:
            continue
        src = ("adv" if q.column.kind == ADVICE else "fix", q.column.index)
        groups[q.rotation].append(
            (src, _eval_label(q.column.kind, q.column.index, q.rotation)))
    for j in range(len(cs.perm_columns)):
        groups[0].append((("sigma", j), f"sigma{j}@0"))
    for ci in range(len(chunks)):
        groups[0].append((("permz", ci), f"permz{ci}@0"))
        groups[1].append((("permz", ci), f"permz{ci}@1"))
        if ci > 0:
            groups[a].append((("permz", ci - 1), f"permz{ci - 1}@{a}"))
    for li in range(len(cs.lookups)):
        groups[0].append((("phi", li), f"phi{li}@0"))
        groups[1].append((("phi", li), f"phi{li}@1"))
        groups[0].append((("m", li), f"lkm{li}@0"))
    for si in range(len(cs.shuffles)):
        groups[0].append((("shz", si), f"shz{si}@0"))
        groups[1].append((("shz", si), f"shz{si}@1"))
    groups[0].append((("rand",), "r@0"))
    for i in range(nh):
        groups[0].append((("h", i), f"h{i}@0"))
    return dict(groups)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def vka_layout(vk: VerifyingKey) -> dict:
    """Byte offsets of the verifying-key artifact (VKA) blob.

    The reusable-verifier pattern (reference `halo2_solidity_verifier`
    render-separately + `src/commands.rs:148` "reusable verifier ~4x
    smaller on-chain state"): the per-circuit CONSTANTS live in a tiny
    data contract (blob-as-code), while the verifier contract — generated
    once per circuit SHAPE — reads them via extcodecopy. Retraining a
    model (same architecture, new weights) redeploys only the VKA.

    Layout: fixed commitments (2 words each) || sigma commitments ||
    [s]G2 (4 words, x1 x0 y1 y0) || G2 (4 words) || vk transcript repr
    (raw bytes, to the end)."""
    nf = len(vk.fixed_commitments)
    ns = len(vk.sigma_commitments)
    off = {"fixed": 0, "sigma": nf * 64}
    off["sg2"] = off["sigma"] + ns * 64
    off["g2"] = off["sg2"] + 128
    off["vkr"] = off["g2"] + 128
    off["vkr_len"] = len(vk.transcript_repr())
    off["size"] = off["vkr"] + off["vkr_len"]
    return off


def generate_vka(vk: VerifyingKey, g2, s_g2) -> str:
    """The VKA data contract: its DEPLOYED code IS the constant blob."""
    lay = vka_layout(vk)
    blob = bytearray()

    def pt_words(pt):
        x, y = (0, 0) if pt is None else pt
        return int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big")

    for pt in vk.fixed_commitments:
        blob += pt_words(pt)
    for pt in vk.sigma_commitments:
        blob += pt_words(pt)
    for fq2 in (s_g2, g2):
        (x0, x1), (y0, y1) = fq2[0], fq2[1]
        for wv in (x1, x0, y1, y0):
            blob += int(wv).to_bytes(32, "big")
    blob += vk.transcript_repr()
    assert len(blob) == lay["size"]
    return "\n".join([
        "// SPDX-License-Identifier: MIT",
        "// Generated by ezkl_tpu.evm.solidity.generate_vka — verifying-key",
        "// artifact: the deployed code of this contract IS the constant",
        "// blob the reusable EzklTpuVerifier extcodecopies.",
        "pragma solidity ^0.8.19;",
        "",
        "contract EzklTpuVKA {",
        "    constructor() {",
        f"        bytes memory d = hex\"{bytes(blob).hex()}\";",
        "        assembly { return(add(d, 0x20), mload(d)) }",
        "    }",
        "}",
    ])


def generate_verifier(vk: VerifyingKey, g2, s_g2,
                      label: bytes = b"ezkl-tpu-evm",
                      reusable: bool = False) -> str:
    cs = vk.cs
    if cs.num_challenges:
        raise NotImplementedError(
            "EVM verifier generation for multi-phase (Freivalds) circuits "
            "is not supported yet — disable_freivalds=True")
    if cs.num_instance > 1:
        raise NotImplementedError("one instance column supported")
    k = vk.k
    n = 1 << k
    a = last_active_row(n)
    P = FR_MODULUS
    omega = root_of_unity(bn254_fr(), k)
    chunks = perm_chunks(cs)
    nh = vk.domain.n_ext // vk.domain.n
    labels = eval_label_list(vk)
    lab_idx = {lab: i for i, lab in enumerate(labels)}
    groups = opening_groups(vk)
    rotations = sorted(groups)  # static rotation set; points sorted at runtime
    n_open = len(rotations)

    # proof layout offsets (bytes)
    n_adv, n_lk, n_ch, n_sh = (cs.num_advice, len(cs.lookups), len(chunks),
                               len(cs.shuffles))
    off = {}
    cur = 0
    for name, cnt, w in (("adv", n_adv, 64), ("m", n_lk, 64),
                         ("permz", n_ch, 64), ("phi", n_lk, 64),
                         ("shz", n_sh, 64), ("rand", 1, 64), ("h", nh, 64),
                         ("evals", len(labels), 32), ("open", n_open, 64)):
        off[name] = cur
        cur += cnt * w
    proof_len = cur

    def pt_load(section, i):
        base = off[section] + 64 * i
        return (f"(uint256(bytes32(proof[{base}:{base + 32}])), "
                f"uint256(bytes32(proof[{base + 32}:{base + 64}])))")

    lay = vka_layout(vk)

    def comm_code(src):
        kind = src[0]
        if kind == "adv":
            return pt_load("adv", src[1])
        if kind == "fix":
            if reusable:
                o = lay["fixed"] + 64 * src[1]
                return f"(vkw(VKD, {o}), vkw(VKD, {o + 32}))"
            pt = vk.fixed_commitments[src[1]]
            x, y = (0, 0) if pt is None else pt
            return f"({hex(x)}, {hex(y)})"
        if kind == "sigma":
            if reusable:
                o = lay["sigma"] + 64 * src[1]
                return f"(vkw(VKD, {o}), vkw(VKD, {o + 32}))"
            pt = vk.sigma_commitments[src[1]]
            x, y = (0, 0) if pt is None else pt
            return f"({hex(x)}, {hex(y)})"
        if kind == "permz":
            return pt_load("permz", src[1])
        if kind == "phi":
            return pt_load("phi", src[1])
        if kind == "m":
            return pt_load("m", src[1])
        if kind == "shz":
            return pt_load("shz", src[1])
        if kind == "rand":
            return pt_load("rand", 0)
        if kind == "h":
            return pt_load("h", src[1])
        raise KeyError(src)

    # instance-eval locals required by gate/lookup expressions
    inst_rots = sorted({q.rotation for q in cs.all_queries()
                        if q.column.kind == INSTANCE})

    def var_ref(kind, index, rotation):
        if kind == INSTANCE:
            return f"ie_{rotation if rotation >= 0 else 'm' + str(-rotation)}"
        return f"E[{lab_idx[_eval_label(kind, index, rotation)]}]"

    def ch_ref(i):
        raise NotImplementedError("phase challenges unsupported in EVM gen")

    body = []
    w = body.append

    # ---- header + helpers
    w("// SPDX-License-Identifier: MIT")
    w("// Generated by ezkl_tpu.evm.solidity.generate_verifier — verifier")
    w(f"// for one fixed circuit (k={k}, {n_adv} advice cols, "
      f"{len(cs.gates)} gates, {n_lk} lookups, {n_sh} shuffles).")
    w("pragma solidity ^0.8.19;")
    w("")
    w("contract EzklTpuVerifier {")
    w(f"    uint256 constant Q = {hex(FQ_MODULUS)}; // BN254 base field")
    w(f"    uint256 constant R = {hex(P)}; // BN254 scalar field")
    w(f"    uint256 constant N = {n};")
    w(f"    uint256 constant OMEGA = {hex(omega)};")
    w(f"    bytes32 constant LABEL_HASH = keccak256(hex\"{label.hex()}\");")
    if reusable:
        w(f"    uint256 constant VKA_SIZE = {lay['size']};")
        w(f"    uint256 constant VKR_OFF = {lay['vkr']};")
        w(f"    uint256 constant VKR_LEN = {lay['vkr_len']};")
    else:
        w(f"    bytes constant VK_REPR = hex\"{vk.transcript_repr().hex()}\";")
        g2x, g2y = g2
        sg2x, sg2y = s_g2
        w(f"    uint256 constant G2_X1 = {hex(g2x[1])};")
        w(f"    uint256 constant G2_X0 = {hex(g2x[0])};")
        w(f"    uint256 constant G2_Y1 = {hex(g2y[1])};")
        w(f"    uint256 constant G2_Y0 = {hex(g2y[0])};")
        w(f"    uint256 constant SG2_X1 = {hex(sg2x[1])};")
        w(f"    uint256 constant SG2_X0 = {hex(sg2x[0])};")
        w(f"    uint256 constant SG2_Y1 = {hex(sg2y[1])};")
        w(f"    uint256 constant SG2_Y0 = {hex(sg2y[0])};")
    w("")
    if reusable:
        w("""    function vkw(bytes memory vkd, uint256 o) internal pure returns (uint256 v) {
        assembly { v := mload(add(add(vkd, 0x20), o)) }
    }""")
    w("""    function absorb(bytes32 st, bytes32 word) internal pure returns (bytes32) {
        return keccak256(abi.encodePacked(st, hex"01", word));
    }
    function absorbPt(bytes32 st, uint256 x, uint256 y) internal pure returns (bytes32) {
        return keccak256(abi.encodePacked(st, hex"01", bytes32(x), bytes32(y)));
    }
    function squeeze(bytes32 st) internal pure returns (bytes32 st2, uint256 ch) {
        bytes32 out = keccak256(abi.encodePacked(st, hex"00"));
        st2 = keccak256(abi.encodePacked(st, hex"02", out));
        ch = uint256(out) % R;
    }
    function ecAdd(uint256 ax, uint256 ay, uint256 bx, uint256 by)
            internal view returns (uint256, uint256) {
        uint256[4] memory inp = [ax, ay, bx, by];
        uint256[2] memory out;
        assembly {
            if iszero(staticcall(gas(), 0x06, inp, 0x80, out, 0x40)) { revert(0, 0) }
        }
        return (out[0], out[1]);
    }
    function ecMul(uint256 ax, uint256 ay, uint256 s)
            internal view returns (uint256, uint256) {
        uint256[3] memory inp = [ax, ay, s];
        uint256[2] memory out;
        assembly {
            if iszero(staticcall(gas(), 0x07, inp, 0x60, out, 0x40)) { revert(0, 0) }
        }
        return (out[0], out[1]);
    }
    function finv(uint256 v) internal view returns (uint256) {
        // v^(R-2) mod R via the modexp precompile
        uint256[6] memory inp = [uint256(32), 32, 32, v, R - 2, R];
        uint256[1] memory out;
        assembly {
            if iszero(staticcall(gas(), 0x05, inp, 0xc0, out, 0x20)) { revert(0, 0) }
        }
        return out[0];
    }
    function fpow(uint256 b, uint256 e) internal view returns (uint256) {
        uint256[6] memory inp = [uint256(32), 32, 32, b, e, R];
        uint256[1] memory out;
        assembly {
            if iszero(staticcall(gas(), 0x05, inp, 0xc0, out, 0x20)) { revert(0, 0) }
        }
        return out[0];
    }
    function checkPoint(uint256 x, uint256 y) internal pure {
        if (x == 0 && y == 0) return; // identity
        require(x < Q && y < Q, "coord range");
        require(mulmod(y, y, Q) ==
                addmod(mulmod(x, mulmod(x, x, Q), Q), 3, Q), "not on curve");
    }""")
    w("")

    # ---- verifyProof
    if reusable:
        w("    function verifyProof(address vka, bytes calldata proof, "
          "uint256[] calldata instances) external view returns (bool) {")
        w("        bytes memory VKD = new bytes(VKA_SIZE);")
        w("        { uint256 cs_;")
        w("          assembly { cs_ := extcodesize(vka) }")
        w("          require(cs_ == VKA_SIZE, \"vka size\"); }")
        w("        assembly { extcodecopy(vka, add(VKD, 0x20), 0, "
          "VKA_SIZE) }")
    else:
        w("    function verifyProof(bytes calldata proof, "
          "uint256[] calldata instances) external view returns (bool) {")
    w(f"        require(proof.length == {proof_len}, \"proof length\");")
    w(f"        uint256[{max(len(labels), 1)}] memory E;")
    w("        for (uint256 i = 0; i < E.length; i++) {")
    w(f"            E[i] = uint256(bytes32(proof[{off['evals']}"
      f" + 32 * i:{off['evals']} + 32 * i + 32]));")
    w("            require(E[i] < R, \"eval range\");")
    w("        }")
    # point validation
    w("        { uint256 px; uint256 py;")
    for sec, cnt in (("adv", n_adv), ("m", n_lk), ("permz", n_ch),
                     ("phi", n_lk), ("shz", n_sh), ("rand", 1), ("h", nh),
                     ("open", n_open)):
        if cnt == 0:
            continue
        w(f"        for (uint256 i = 0; i < {cnt}; i++) {{")
        w(f"            px = uint256(bytes32(proof[{off[sec]} + 64 * i:"
          f"{off[sec]} + 64 * i + 32]));")
        w(f"            py = uint256(bytes32(proof[{off[sec]} + 64 * i + 32:"
          f"{off[sec]} + 64 * i + 64]));")
        w("            checkPoint(px, py);")
        w("        }")
    w("        }")
    # ---- transcript replay
    w("        bytes32 st = LABEL_HASH;")
    if reusable:
        w("        {")
        w("            bytes memory vkr = new bytes(VKR_LEN);")
        w("            for (uint256 i = 0; i < VKR_LEN; i++) "
          "vkr[i] = VKD[VKR_OFF + i];")
        w("            st = keccak256(abi.encodePacked(st, hex\"01\", vkr));")
        w("        }")
    else:
        w("        st = keccak256(abi.encodePacked(st, hex\"01\", VK_REPR));")
    w("        for (uint256 i = 0; i < instances.length; i++) {")
    w("            require(instances[i] < R, \"instance range\");")
    w("            st = absorb(st, bytes32(instances[i]));")
    w("        }")

    def absorb_section(sec, cnt, indices=None):
        if indices is not None:
            for i in indices:
                w(f"        st = keccak256(abi.encodePacked(st, hex\"01\", "
                  f"proof[{off[sec] + 64 * i}:{off[sec] + 64 * i + 64}]));")
        elif cnt:
            w(f"        for (uint256 i = 0; i < {cnt}; i++) st = "
              f"keccak256(abi.encodePacked(st, hex\"01\", "
              f"proof[{off[sec]} + 64 * i:{off[sec]} + 64 * i + 64]));")

    # advice by phase (phase-0 first; no phase challenges supported)
    p0 = [i for i in range(n_adv) if cs.advice_phase[i] == 0]
    p1 = [i for i in range(n_adv) if cs.advice_phase[i] != 0]
    absorb_section("adv", None, p0)
    absorb_section("adv", None, p1)
    w("        uint256 theta; (st, theta) = squeeze(st);")
    absorb_section("m", n_lk)
    w("        uint256 beta; (st, beta) = squeeze(st);")
    w("        uint256 gamma; (st, gamma) = squeeze(st);")
    absorb_section("permz", n_ch)
    absorb_section("phi", n_lk)
    absorb_section("shz", n_sh)
    absorb_section("rand", 1)
    w("        uint256 y_ch; (st, y_ch) = squeeze(st);")
    absorb_section("h", nh)
    w("        uint256 x_ch; (st, x_ch) = squeeze(st);")
    w("        for (uint256 i = 0; i < E.length; i++) "
      "st = absorb(st, bytes32(E[i]));")
    w("        uint256 v_ch; (st, v_ch) = squeeze(st);")
    absorb_section("open", n_open)
    w("        uint256 u_ch; (st, u_ch) = squeeze(st);")
    w("        return checkIdentities(proof, instances, "
      "[theta, beta, gamma, y_ch, x_ch, v_ch, u_ch], E);")
    w("    }")
    w("")

    # ---- identity + multiopen checks (separate function: stack depth)
    w(f"    function checkIdentities(bytes calldata proof, "
      f"uint256[] calldata instances, uint256[7] memory ch, "
      f"uint256[{max(len(labels), 1)}] memory E) "
      f"internal view returns (bool) {{")
    w("        uint256 theta = ch[0]; uint256 beta = ch[1]; "
      "uint256 gamma = ch[2];")
    w("        uint256 y_ch = ch[3]; uint256 x_ch = ch[4];")
    w("        uint256 xn = fpow(x_ch, N);")
    w("        uint256 zh = addmod(xn, R - 1, R);")
    # instance evals at required rotations
    for rot in inst_rots:
        nm = f"ie_{rot if rot >= 0 else 'm' + str(-rot)}"
        rot_om = pow(omega, rot % (P - 1), P) if rot >= 0 else pow(
            pow(omega, -1, P), -rot, P)
        w(f"        uint256 {nm};")
        w("        {")
        w(f"            uint256 z = mulmod(x_ch, {hex(rot_om)}, R);")
        w("            uint256 zn1 = addmod(fpow(z, N), R - 1, R);")
        w("            uint256 wi = 1; uint256 acc = 0;")
        w("            for (uint256 i = 0; i < instances.length; i++) {")
        w("                acc = addmod(acc, mulmod(mulmod(instances[i], wi, R),"
          " finv(addmod(z, R - wi, R)), R), R);")
        w("                wi = mulmod(wi, OMEGA, R);")
        w("            }")
        w(f"            {nm} = mulmod(mulmod(acc, zn1, R), "
          f"{hex(pow(n, -1, P))}, R);")
        w("        }")
    # l0, llast, not_last
    w("        uint256 l0; uint256 llast; uint256 notLast;")
    w("        {")
    w("            uint256 zn1 = zh;")
    w(f"            l0 = mulmod(mulmod(zn1, 1, R), finv(mulmod({n}, "
      f"addmod(x_ch, R - 1, R), R)), R);")
    w(f"            uint256 wa = {hex(pow(omega, a, P))};")
    w(f"            llast = mulmod(mulmod(zn1, wa, R), finv(mulmod({n}, "
      f"addmod(x_ch, R - wa, R), R)), R);")
    w("            uint256 bs = llast;")
    for i in range(a + 1, n):
        wi = pow(omega, i, P)
        w(f"            bs = addmod(bs, mulmod(mulmod(zn1, {hex(wi)}, R), "
          f"finv(mulmod({n}, addmod(x_ch, R - {hex(wi)}, R), R)), R), R);")
    w("            notLast = addmod(1, R - bs, R);")
    w("        }")
    # total accumulation
    w("        uint256 total = 0;")

    def acc_line(term_code):
        w(f"        total = addmod(mulmod(total, y_ch, R), {term_code}, R);")

    for g in cs.gates:
        acc_line(expr_code(g.poly, var_ref, ch_ref))
    # permutation chunks
    for ci, cset in enumerate(chunks):
        zx = f"E[{lab_idx[f'permz{ci}@0']}]"
        zwx = f"E[{lab_idx[f'permz{ci}@1']}]"
        w("        {")
        w("            uint256 num = 1; uint256 den = 1; uint256 v;")
        for j in cset:
            c = cs.perm_columns[j]
            v_code = var_ref(c.kind, c.index, 0)
            idj = pow(DELTA, j, P)
            w(f"            v = {v_code};")
            w(f"            num = mulmod(num, addmod(addmod(v, mulmod(beta, "
              f"mulmod({hex(idj)}, x_ch, R), R), R), gamma, R), R);")
            sig = f"E[{lab_idx[f'sigma{j}@0']}]"
            w(f"            den = mulmod(den, addmod(addmod(v, mulmod(beta, "
              f"{sig}, R), R), gamma, R), R);")
        w(f"            total = addmod(mulmod(total, y_ch, R), mulmod(notLast,"
          f" addmod(mulmod({zwx}, den, R), R - mulmod({zx}, num, R), R), R), R);")
        if ci == 0:
            w(f"            total = addmod(mulmod(total, y_ch, R), mulmod(l0, "
              f"addmod({zx}, R - 1, R), R), R);")
        else:
            prev = f"E[{lab_idx[f'permz{ci - 1}@{a}']}]"
            w(f"            total = addmod(mulmod(total, y_ch, R), mulmod(l0, "
              f"addmod({zx}, R - {prev}, R), R), R);")
        if ci == len(chunks) - 1:
            w(f"            total = addmod(mulmod(total, y_ch, R), mulmod("
              f"llast, addmod({zx}, R - 1, R), R), R);")
        w("        }")

    def compress_code(tup):
        code = "0"
        for e in tup:
            ec = expr_code(e, var_ref, ch_ref)
            code = f"addmod(mulmod({code}, theta, R), {ec}, R)"
        return code

    for li, lk in enumerate(cs.lookups):
        phx = f"E[{lab_idx[f'phi{li}@0']}]"
        phwx = f"E[{lab_idx[f'phi{li}@1']}]"
        mx = f"E[{lab_idx[f'lkm{li}@0']}]"
        w("        {")
        w(f"            uint256 tpb = addmod({compress_code(lk.table)}, "
          f"beta, R);")
        nf = len(lk.inputs)
        for fi, tup in enumerate(lk.inputs):
            w(f"            uint256 f{fi} = addmod({compress_code(tup)}, "
              f"beta, R);")
        prod = "f0"
        for fi in range(1, nf):
            prod = f"mulmod({prod}, f{fi}, R)"
        w(f"            uint256 prodF = {prod};")
        if nf == 1:
            w("            uint256 sumExc = 1;")
        else:
            terms = []
            for kk in range(nf):
                pr = None
                for jj in range(nf):
                    if jj == kk:
                        continue
                    pr = f"f{jj}" if pr is None else f"mulmod({pr}, f{jj}, R)"
                terms.append(pr)
            se = terms[0]
            for t in terms[1:]:
                se = f"addmod({se}, {t}, R)"
            w(f"            uint256 sumExc = {se};")
        w(f"            uint256 run = addmod(mulmod(mulmod(addmod({phwx}, "
          f"R - {phx}, R), prodF, R), tpb, R), R - addmod(mulmod(tpb, sumExc,"
          f" R), R - mulmod({mx}, prodF, R), R), R);")
        w("            total = addmod(mulmod(total, y_ch, R), "
          "mulmod(notLast, run, R), R);")
        w(f"            total = addmod(mulmod(total, y_ch, R), "
          f"mulmod(l0, {phx}, R), R);")
        w(f"            total = addmod(mulmod(total, y_ch, R), "
          f"mulmod(llast, {phx}, R), R);")
        w("        }")

    for si, sh in enumerate(cs.shuffles):
        zx = f"E[{lab_idx[f'shz{si}@0']}]"
        zwx = f"E[{lab_idx[f'shz{si}@1']}]"
        w("        {")
        w(f"            uint256 ax = addmod({compress_code(sh.input)}, "
          f"gamma, R);")
        w(f"            uint256 bx = addmod({compress_code(sh.table)}, "
          f"gamma, R);")
        w(f"            total = addmod(mulmod(total, y_ch, R), mulmod(notLast,"
          f" addmod(mulmod({zwx}, bx, R), R - mulmod({zx}, ax, R), R), R), R);")
        w(f"            total = addmod(mulmod(total, y_ch, R), mulmod(l0, "
          f"addmod({zx}, R - 1, R), R), R);")
        w(f"            total = addmod(mulmod(total, y_ch, R), mulmod(llast, "
          f"addmod({zx}, R - 1, R), R), R);")
        w("        }")

    # quotient identity
    hx = "0"
    for i in range(nh - 1, -1, -1):
        hx = f"addmod(mulmod({hx}, xn, R), E[{lab_idx[f'h{i}@0']}], R)"
    w(f"        if (total != mulmod(zh, {hx}, R)) return false;")
    if reusable:
        w("        return multiopen(proof, ch, VKD);")
    else:
        w("        return multiopen(proof, ch);")
    w("    }")
    w("")

    # ---- multiopen
    if reusable:
        w("    function multiopen(bytes calldata proof, uint256[7] memory "
          "ch, bytes memory VKD) internal view returns (bool) {")
    else:
        w("    function multiopen(bytes calldata proof, uint256[7] memory "
          "ch) internal view returns (bool) {")
    w("        uint256 x_ch = ch[4]; uint256 v_ch = ch[5]; "
      "uint256 u_ch = ch[6];")
    w(f"        uint256[{n_open}] memory pts;")
    w(f"        uint256[{n_open}] memory cx;")
    w(f"        uint256[{n_open}] memory cy;")
    w(f"        uint256[{n_open}] memory vv;")
    for gi, rot in enumerate(rotations):
        if rot == 0:
            w(f"        pts[{gi}] = x_ch;")
        else:
            rot_om = pow(omega, rot, P) if rot >= 0 else pow(
                pow(omega, -1, P), -rot, P)
            w(f"        pts[{gi}] = mulmod(x_ch, {hex(rot_om)}, R);")
        w("        {")
        w("            uint256 gx; uint256 gy; uint256 gv; "
          "uint256 tx_; uint256 ty_;")
        for ii, (src, lab) in enumerate(groups[rot]):
            evi = lab_idx[lab]
            ev = (f"uint256(bytes32(proof[{off['evals'] + 32 * evi}:"
                  f"{off['evals'] + 32 * evi + 32}]))")
            w(f"            (tx_, ty_) = {comm_code(src)};")
            if ii == 0:
                w("            (gx, gy) = (tx_, ty_);")
                w(f"            gv = {ev};")
            else:
                w("            (gx, gy) = ecMul(gx, gy, v_ch);")
                w("            (gx, gy) = ecAdd(gx, gy, tx_, ty_);")
                w(f"            gv = addmod(mulmod(gv, v_ch, R), {ev}, R);")
        w(f"            cx[{gi}] = gx; cy[{gi}] = gy; vv[{gi}] = gv;")
        w("        }")
    # sort openings by point value (insertion sort over tiny arrays); the
    # i-th opening commitment corresponds to the i-th smallest point
    w(f"        uint256[{n_open}] memory ord;")
    w(f"        for (uint256 i = 0; i < {n_open}; i++) ord[i] = i;")
    w(f"        for (uint256 i = 1; i < {n_open}; i++)")
    w("            for (uint256 j = i; j > 0 && pts[ord[j - 1]] > "
      "pts[ord[j]]; j--) { uint256 t = ord[j]; ord[j] = ord[j - 1]; "
      "ord[j - 1] = t; }")
    w("        uint256 lx = 0; uint256 ly = 0; uint256 rx = 0; "
      "uint256 ry = 0; uint256 up = 1;")
    w(f"        for (uint256 oi = 0; oi < {n_open}; oi++) {{")
    w("            uint256 gi = ord[oi];")
    w(f"            uint256 wx = uint256(bytes32(proof[{off['open']}"
      f" + 64 * oi:{off['open']} + 64 * oi + 32]));")
    w(f"            uint256 wy = uint256(bytes32(proof[{off['open']}"
      f" + 64 * oi + 32:{off['open']} + 64 * oi + 64]));")
    w("            (uint256 tx_, uint256 ty_) = ecMul(wx, wy, pts[gi]);")
    w("            (tx_, ty_) = ecAdd(tx_, ty_, cx[gi], cy[gi]);")
    w("            (uint256 vx, uint256 vy) = ecMul(1, 2, "
      "(R - vv[gi]) % R);")
    w("            (tx_, ty_) = ecAdd(tx_, ty_, vx, vy);")
    w("            (tx_, ty_) = ecMul(tx_, ty_, up);")
    w("            (rx, ry) = ecAdd(rx, ry, tx_, ty_);")
    w("            (tx_, ty_) = ecMul(wx, wy, up);")
    w("            (lx, ly) = ecAdd(lx, ly, tx_, ty_);")
    w("            up = mulmod(up, u_ch, R);")
    w("        }")
    w("        // e(lhs, s_g2) . e(-rhs, g2) == 1")
    w("        if (!(rx == 0 && ry == 0)) ry = Q - ry;")
    if reusable:
        o = lay["sg2"]
        og = lay["g2"]
        w(f"        uint256[12] memory inp = [lx, ly, vkw(VKD, {o}), "
          f"vkw(VKD, {o + 32}), vkw(VKD, {o + 64}), vkw(VKD, {o + 96}), "
          f"rx, ry, vkw(VKD, {og}), vkw(VKD, {og + 32}), "
          f"vkw(VKD, {og + 64}), vkw(VKD, {og + 96})];")
    else:
        w("        uint256[12] memory inp = [lx, ly, SG2_X1, SG2_X0, "
          "SG2_Y1, SG2_Y0, rx, ry, G2_X1, G2_X0, G2_Y1, G2_Y0];")
    w("        uint256[1] memory out;")
    w("        assembly {")
    w("            if iszero(staticcall(gas(), 0x08, inp, 0x180, out, 0x20))"
      " { revert(0, 0) }")
    w("        }")
    w("        return out[0] == 1;")
    w("    }")
    w("}")
    return "\n".join(body)
