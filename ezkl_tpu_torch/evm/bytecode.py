"""Direct EVM bytecode emission for the ezkl_tpu verifier (copy of
`ezkl_tpu/evm/bytecode.py`: for one verifying key both packages emit the
same bytes).

The reference deploys solc/foundry-compiled Solidity to a devnet and
verifies on-chain (`ezkl/src/eth.rs:162-377`; 23 models in
`tests/integration_tests.rs:299-323`). Without solc, the
deployable artifact is emitted straight to EVM bytecode from the same
VerifyingKey the Solidity generator consumes — and EXECUTED on the in-repo
EVM (`ezkl_tpu_torch.evm.vm`), closing the loop the Solidity twin test could not:
transcript replay, calldata layout, precompile semantics and the final
pairing all run on an actual EVM machine model.

ABI: the contract takes `api.encode_evm_calldata` output VERBATIM as its
whole calldata — proof bytes (commitments | evals | openings, statically
sized per circuit) followed by `n_inst` instance words — and returns one
32-byte word: 1 (valid) / 0 (invalid). Malformed input (bad length,
out-of-range scalars, off-curve points) REVERTs, mirroring the generated
Solidity's `require`s.

Code generation style: three-address code over fixed MEMORY slots — every
intermediate lands in memory, the stack only carries the operands of the
instruction being executed (plus recursion for expression trees). Slower
in gas than tight stack code, irrelevant for correctness testing, and easy
to audit. Control flow is fully unrolled except subroutines (finv/fpow/
ecadd/ecmul/checkpoint) and the compare-swap network's conditional skips.

Memory map (per call):
  0x000-0x17f  precompile input staging (12 words for the pairing)
  0x180-0x1bf  precompile / subroutine output
  0x1c0-0x23f  transcript hash buffer: state(32) | tag(1) | payload
  0x240        transcript state
  0x260-0x33f  challenges: theta beta gamma y x v u
  0x340-0x4ff  named scalar scratch (xn, zh, l0, ..., temps)
  0x500-       E[] evals, then multiopen arrays pts/cx/cy/vv/ord, acc slots
"""

from __future__ import annotations

from ..fieldmath.spec import FR_MODULUS, FQ_MODULUS, bn254_fr
from ..kernels.ntt import root_of_unity
from ..plonk.cs import (Challenge, Constant, Product, Scaled, Sum, Var,
                        INSTANCE, last_active_row)
from ..plonk.keygen import VerifyingKey, DELTA
from ..plonk.prover import _eval_label
from ..utils.keccak import keccak256
from . import solidity

P = FR_MODULUS
Q = FQ_MODULUS

# opcodes
ADD, MUL, SUB, MOD = 0x01, 0x02, 0x03, 0x06
ADDMOD, MULMOD = 0x08, 0x09
LT, GT, EQ, ISZERO, AND = 0x10, 0x11, 0x14, 0x15, 0x16
KECCAK = 0x20
CALLDATALOAD, CALLDATASIZE, CALLDATACOPY = 0x35, 0x36, 0x37
POP, MLOAD, MSTORE, MSTORE8 = 0x50, 0x51, 0x52, 0x53
JUMP, JUMPI, JUMPDEST, GAS = 0x56, 0x57, 0x5B, 0x5A
DUP1, DUP2, SWAP1, SWAP2, SWAP3 = 0x80, 0x81, 0x90, 0x91, 0x92
STATICCALL, RETURN, REVERT = 0xFA, 0xF3, 0xFD

# memory offsets
M_PIN, M_POUT = 0x000, 0x180
M_HBUF, M_HTAG, M_HPAY = 0x1C0, 0x1E0, 0x1E1
M_ST = 0x240
M_CH = 0x260
M_XN, M_ZH, M_L0, M_LLAST, M_NOTLAST, M_TOTAL = (
    0x340, 0x360, 0x380, 0x3A0, 0x3C0, 0x3E0)
M_T0, M_T1, M_T2, M_T3, M_T4 = 0x400, 0x420, 0x440, 0x460, 0x480
M_IE = 0x4A0                      # instance evals (<= 3 rotations)
M_E = 0x500


class Asm:
    """Two-pass assembler: raw opcodes, minimal-width immediate pushes, and
    label references emitted as fixed-width PUSH3 (stable offsets)."""

    def __init__(self):
        self.items: list = []

    def op(self, *codes):
        self.items.extend(codes)

    def push(self, v: int):
        self.items.append(("push", int(v)))

    def label(self, name: str):
        self.items.append(("label", name))

    def ref(self, name: str):
        self.items.append(("ref", name))

    def jump(self, name: str):
        self.ref(name)
        self.op(JUMP)

    def jumpi(self, name: str):
        """[cond] -> consume cond, jump if nonzero. JUMPI pops (dest, cond)
        with dest on top — exactly the order ref() leaves."""
        self.ref(name)
        self.op(JUMPI)

    def assemble(self) -> bytes:
        offs: dict[str, int] = {}
        pos = 0
        for it in self.items:
            if isinstance(it, int):
                pos += 1
            elif it[0] == "push":
                pos += 1 + max(1, (it[1].bit_length() + 7) // 8)
            elif it[0] == "label":
                offs[it[1]] = pos
                pos += 1
            else:
                pos += 4
        out = bytearray()
        for it in self.items:
            if isinstance(it, int):
                out.append(it)
            elif it[0] == "push":
                v = it[1]
                nb = max(1, (v.bit_length() + 7) // 8)
                out.append(0x5F + nb)
                out += v.to_bytes(nb, "big")
            elif it[0] == "label":
                out.append(JUMPDEST)
            else:
                out.append(0x62)
                out += offs[it[1]].to_bytes(3, "big")
        return bytes(out)


def initcode(runtime: bytes) -> bytes:
    """Constructor wrapper: CODECOPY the runtime to memory and RETURN it."""
    pre = bytearray()
    pre += b"\x62" + len(runtime).to_bytes(3, "big")      # PUSH3 len
    pre += b"\x80"                                         # DUP1
    pre += b"\x62" + (13).to_bytes(3, "big")               # PUSH3 src offset
    pre += b"\x5f\x39\x5f\xf3"                             # PUSH0 CODECOPY PUSH0 RETURN
    assert len(pre) == 13
    return bytes(pre) + runtime


def emit_verifier(vk: VerifyingKey, g2, s_g2, n_inst: int,
                  label: bytes = b"ezkl-tpu-evm") -> bytes:
    """Runtime bytecode verifying EvmTranscript proofs of `vk`'s circuit.

    Mirrors `solidity.generate_verifier` section by section (same
    eval-label order, opening groups and transcript byte protocol)."""
    cs = vk.cs
    if cs.num_challenges:
        raise NotImplementedError("multi-phase circuits: disable_freivalds")
    if cs.num_instance > 1:
        raise NotImplementedError("one instance column supported")
    k = vk.k
    n = 1 << k
    a_row = last_active_row(n)
    omega = root_of_unity(bn254_fr(), k)
    chunks = solidity.perm_chunks(cs)
    nh = vk.domain.n_ext // vk.domain.n
    labels = solidity.eval_label_list(vk)
    lab_idx = {lab: i for i, lab in enumerate(labels)}
    groups = solidity.opening_groups(vk)
    rotations = sorted(groups)
    n_open = len(rotations)

    n_adv, n_lk, n_ch_, n_sh = (cs.num_advice, len(cs.lookups), len(chunks),
                                len(cs.shuffles))
    off = {}
    cur = 0
    for name, cnt, w in (("adv", n_adv, 64), ("m", n_lk, 64),
                         ("permz", n_ch_, 64), ("phi", n_lk, 64),
                         ("shz", n_sh, 64), ("rand", 1, 64), ("h", nh, 64),
                         ("evals", len(labels), 32), ("open", n_open, 64)):
        off[name] = cur
        cur += cnt * w
    proof_len = cur

    M_PTS = M_E + 32 * len(labels)
    M_CX = M_PTS + 32 * n_open
    M_CY = M_CX + 32 * n_open
    M_VV = M_CY + 32 * n_open
    M_ORD = M_VV + 32 * n_open
    M_LX = M_ORD + 32 * n_open
    M_LY, M_RX, M_RY, M_UP = M_LX + 32, M_LX + 64, M_LX + 96, M_LX + 128

    inst_rots = sorted({q.rotation for q in cs.all_queries()
                        if q.column.kind == INSTANCE})
    ie_slot = {rot: M_IE + 32 * i for i, rot in enumerate(inst_rots)}
    assert len(inst_rots) <= 3, "instance rotation scratch exhausted"

    A = Asm()
    _f = [0]

    def lbl(base):
        _f[0] += 1
        return f"{base}_{_f[0]}"

    # ---- slot/stack primitives -------------------------------------------
    def load(slot):
        A.push(slot)
        A.op(MLOAD)

    def store(slot):
        """[v] -> mem[slot] = v"""
        A.push(slot)
        A.op(MSTORE)

    def cdload(o):
        A.push(o)
        A.op(CALLDATALOAD)

    def revert():
        A.push(0)
        A.push(0)
        A.op(REVERT)

    def require():
        """[cond] -> revert unless cond"""
        okl = lbl("ok")
        A.jumpi(okl)
        revert()
        A.label(okl)

    def ret_bool(v: int):
        A.push(v)
        store(M_POUT)
        A.push(32)
        A.push(M_POUT)
        A.op(RETURN)

    # value emitters: each pushes exactly ONE value on the stack
    def vc(x):
        return lambda: A.push(x % P)

    def vm(slot):
        return lambda: load(slot)

    def vcd(o):
        return lambda: cdload(o)

    def vop(opc, va, vb):
        """(va op vb) mod P — ADDMOD/MULMOD pop (b, a, N)."""
        def f():
            A.push(P)
            va()
            vb()
            A.op(opc)
        return f

    def vsub(va, vb):
        """(va - vb) mod P  ==  va + (P - vb)  (vb() < P always holds)."""
        def f():
            A.push(P)
            va()
            A.push(P)
            vb()
            A.op(SWAP1, SUB)     # P - vb
            A.op(ADDMOD)
        return f

    vmul = lambda a, b: vop(MULMOD, a, b)
    vadd = lambda a, b: vop(ADDMOD, a, b)

    # ---- subroutines (results in M_POUT, never on the stack) -------------
    def sub_call(name, *arg_emitters):
        """Args are pushed in order; LAST one ends on top."""
        r = lbl(f"r_{name}")
        A.ref(r)
        for e in arg_emitters:
            e()
        A.jump(name)
        A.label(r)

    def emit_modexp_sub(name):
        """[ret, e, b] (b top) -> M_POUT = b^e mod P"""
        A.label(name)
        store(0x60)                  # base
        store(0x80)                  # exponent
        A.push(32); store(0x00)
        A.push(32); store(0x20)
        A.push(32); store(0x40)
        A.push(P); store(0xA0)
        A.push(32); A.push(M_POUT); A.push(0xC0); A.push(0)
        A.push(0x05); A.op(GAS, STATICCALL)
        require()
        A.op(JUMP)                   # ret now on top

    def emit_subroutines():
        # fpow: [ret, e, b] -> M_POUT
        emit_modexp_sub("fpow")

        # finv: [ret, v] -> M_POUT  (v^(P-2))
        A.label("finv")
        store(0x60)
        A.push(32); store(0x00)
        A.push(32); store(0x20)
        A.push(32); store(0x40)
        A.push(P - 2); store(0x80)
        A.push(P); store(0xA0)
        A.push(32); A.push(M_POUT); A.push(0xC0); A.push(0)
        A.push(0x05); A.op(GAS, STATICCALL)
        require()
        A.op(JUMP)

        # ecadd: [ret, by, bx, ay, ax] (ax top) -> M_POUT = (x, y)
        A.label("ecadd")
        store(0x00)
        store(0x20)
        store(0x40)
        store(0x60)
        A.push(0x40); A.push(M_POUT); A.push(0x80); A.push(0)
        A.push(0x06); A.op(GAS, STATICCALL)
        require()
        A.op(JUMP)

        # ecmul: [ret, s, y, x] (x top) -> M_POUT
        A.label("ecmul")
        store(0x00)
        store(0x20)
        store(0x40)
        A.push(0x40); A.push(M_POUT); A.push(0x60); A.push(0)
        A.push(0x07); A.op(GAS, STATICCALL)
        require()
        A.op(JUMP)

        # checkpoint: [ret, y, x] (x top) -> [] ; reverts if off-curve
        A.label("checkpoint")
        store(M_T0)                  # x
        store(M_T1)                  # y
        okl = lbl("cp_ok")
        full = lbl("cp_full")
        load(M_T0)
        A.jumpi(full)
        load(M_T1)
        A.op(ISZERO)
        A.jumpi(okl)                 # (0,0) identity
        A.label(full)
        load(M_T0); A.push(Q); A.op(SWAP1, LT)   # x < Q
        require()
        load(M_T1); A.push(Q); A.op(SWAP1, LT)
        require()
        # y^2 == x^3 + 3 mod Q
        A.push(Q)
        A.push(Q)
        A.push(Q)
        load(M_T0)
        load(M_T0)
        A.op(MULMOD)
        load(M_T0)
        A.op(MULMOD)                 # x^3
        A.push(3)
        A.op(ADDMOD)                 # rhs
        A.push(Q)
        load(M_T1)
        load(M_T1)
        A.op(MULMOD)                 # lhs
        A.op(EQ)
        require()
        A.label(okl)
        A.op(JUMP)

    # =======================================================================
    # entry
    # =======================================================================
    A.op(CALLDATASIZE)
    A.push(proof_len + 32 * n_inst)
    A.op(EQ)
    require()

    # load + range-check evals into memory
    for i in range(len(labels)):
        cdload(off["evals"] + 32 * i)
        A.op(DUP1)
        A.push(P)
        A.op(SWAP1, LT)              # e < P
        require()
        store(M_E + 32 * i)

    # validate every proof point
    for sec, cnt in (("adv", n_adv), ("m", n_lk), ("permz", n_ch_),
                     ("phi", n_lk), ("shz", n_sh), ("rand", 1), ("h", nh),
                     ("open", n_open)):
        for i in range(cnt):
            po = off[sec] + 64 * i
            sub_call("checkpoint", vcd(po + 32), vcd(po))

    # ---------- transcript replay ----------
    st0 = keccak256(label)
    st1 = keccak256(st0 + b"\x01" + vk.transcript_repr())
    A.push(int.from_bytes(st1, "big"))
    store(M_ST)

    def absorb_calldata(o, length):
        load(M_ST)
        store(M_HBUF)
        A.push(1); A.push(M_HTAG); A.op(MSTORE8)
        A.push(length); A.push(o); A.push(M_HPAY); A.op(CALLDATACOPY)
        A.push(33 + length); A.push(M_HBUF); A.op(KECCAK)
        store(M_ST)

    def absorb_word(vemit):
        vemit()
        store(M_HPAY)
        load(M_ST)
        store(M_HBUF)
        A.push(1); A.push(M_HTAG); A.op(MSTORE8)
        A.push(65); A.push(M_HBUF); A.op(KECCAK)
        store(M_ST)

    def squeeze(slot):
        load(M_ST)
        store(M_HBUF)
        A.push(0); A.push(M_HTAG); A.op(MSTORE8)
        A.push(33); A.push(M_HBUF); A.op(KECCAK)
        A.op(DUP1)
        store(M_HPAY)
        A.push(2); A.push(M_HTAG); A.op(MSTORE8)
        # st = keccak(st || 0x02 || out): buffer still holds st at M_HBUF
        A.push(65); A.push(M_HBUF); A.op(KECCAK)
        store(M_ST)
        A.push(P)
        A.op(SWAP1, MOD)
        store(slot)

    for i in range(n_inst):
        cdload(proof_len + 32 * i)
        A.op(DUP1)
        A.push(P)
        A.op(SWAP1, LT)
        require()
        absorb_word(lambda: None)    # value already on stack

    CH = {nm: M_CH + 32 * j for j, nm in enumerate(
        ("theta", "beta", "gamma", "y", "x", "v", "u"))}

    p0 = [i for i in range(n_adv) if cs.advice_phase[i] == 0]
    p1 = [i for i in range(n_adv) if cs.advice_phase[i] != 0]
    for i in p0 + p1:
        absorb_calldata(off["adv"] + 64 * i, 64)
    squeeze(CH["theta"])
    for i in range(n_lk):
        absorb_calldata(off["m"] + 64 * i, 64)
    squeeze(CH["beta"])
    squeeze(CH["gamma"])
    for i in range(n_ch_):
        absorb_calldata(off["permz"] + 64 * i, 64)
    for i in range(n_lk):
        absorb_calldata(off["phi"] + 64 * i, 64)
    for i in range(n_sh):
        absorb_calldata(off["shz"] + 64 * i, 64)
    absorb_calldata(off["rand"], 64)
    squeeze(CH["y"])
    for i in range(nh):
        absorb_calldata(off["h"] + 64 * i, 64)
    squeeze(CH["x"])
    for i in range(len(labels)):
        absorb_word(vm(M_E + 32 * i))
    squeeze(CH["v"])
    for i in range(n_open):
        absorb_calldata(off["open"] + 64 * i, 64)
    squeeze(CH["u"])

    # ---------- scalar identities ----------
    # xn = x^N ; zh = xn - 1
    sub_call("fpow", vc(n), vm(CH["x"]))
    load(M_POUT)
    store(M_XN)
    vadd(vm(M_XN), vc(P - 1))()
    store(M_ZH)

    ninv = pow(n, -1, P)
    for rot in inst_rots:
        rot_om = pow(omega, rot, P) if rot >= 0 else pow(
            pow(omega, -1, P), -rot, P)
        # z = x * w^rot, zn1 = z^n - 1, acc = 0
        vmul(vm(CH["x"]), vc(rot_om))()
        store(M_T2)                               # z
        sub_call("fpow", vc(n), vm(M_T2))
        vadd(vm(M_POUT), vc(P - 1))()
        store(M_T3)                               # zn1
        A.push(0)
        store(M_T4)                               # acc
        for i in range(n_inst):
            wi = pow(omega, i, P)
            sub_call("finv", vsub(vm(M_T2), vc(wi)))
            vadd(vm(M_T4),
                 vmul(vmul(vcd(proof_len + 32 * i), vc(wi)), vm(M_POUT)))()
            store(M_T4)
        vmul(vmul(vm(M_T4), vm(M_T3)), vc(ninv))()
        store(ie_slot[rot])

    # l_i(x) = zh * w^i / (n * (x - w^i))
    def lag(slot_or_none, wi):
        sub_call("finv", vmul(vsub(vm(CH["x"]), vc(wi)), vc(n)))
        vmul(vmul(vm(M_ZH), vc(wi)), vm(M_POUT))()
        if slot_or_none is not None:
            store(slot_or_none)

    lag(M_L0, 1)
    lag(M_LLAST, pow(omega, a_row, P))
    load(M_LLAST)
    store(M_T2)                                   # bs
    for i in range(a_row + 1, n):
        lag(M_T3, pow(omega, i, P))
        vadd(vm(M_T2), vm(M_T3))()
        store(M_T2)
    vsub(vc(1), vm(M_T2))()
    store(M_NOTLAST)

    # ---------- total accumulation ----------
    def e_val(labtxt):
        return vm(M_E + 32 * lab_idx[labtxt])

    def expr_v(expr):
        if isinstance(expr, Constant):
            return vc(expr.value)
        if isinstance(expr, Var):
            q = expr.query
            if q.column.kind == INSTANCE:
                return vm(ie_slot[q.rotation])
            return e_val(_eval_label(q.column.kind, q.column.index,
                                     q.rotation))
        if isinstance(expr, Challenge):
            raise NotImplementedError("phase challenges unsupported")
        if isinstance(expr, Sum):
            return vadd(expr_v(expr.a), expr_v(expr.b))
        if isinstance(expr, Product):
            return vmul(expr_v(expr.a), expr_v(expr.b))
        if isinstance(expr, Scaled):
            return vmul(expr_v(expr.a), vc(expr.k))
        raise TypeError(type(expr))

    A.push(0)
    store(M_TOTAL)

    def acc_term(vterm):
        vadd(vmul(vm(M_TOTAL), vm(CH["y"])), vterm)()
        store(M_TOTAL)

    for g in cs.gates:
        acc_term(expr_v(g.poly))

    S_NUM, S_DEN = M_T0, M_T1
    for ci, cset in enumerate(chunks):
        zx, zwx = f"permz{ci}@0", f"permz{ci}@1"
        A.push(1); store(S_NUM)
        A.push(1); store(S_DEN)
        for j in cset:
            c = cs.perm_columns[j]
            idj = pow(DELTA, j, P)
            vcol = (vm(ie_slot[0]) if c.kind == INSTANCE
                    else e_val(_eval_label(c.kind, c.index, 0)))
            fa = vadd(vadd(vcol, vmul(vmul(vm(CH["beta"]), vc(idj)),
                                      vm(CH["x"]))), vm(CH["gamma"]))
            fb = vadd(vadd(vcol, vmul(vm(CH["beta"]), e_val(f"sigma{j}@0"))),
                      vm(CH["gamma"]))
            vmul(vm(S_NUM), fa)()
            store(S_NUM)
            vmul(vm(S_DEN), fb)()
            store(S_DEN)
        acc_term(vmul(vm(M_NOTLAST),
                      vsub(vmul(e_val(zwx), vm(S_DEN)),
                           vmul(e_val(zx), vm(S_NUM)))))
        if ci == 0:
            acc_term(vmul(vm(M_L0), vsub(e_val(zx), vc(1))))
        else:
            acc_term(vmul(vm(M_L0),
                          vsub(e_val(zx), e_val(f"permz{ci - 1}@{a_row}"))))
        if ci == len(chunks) - 1:
            acc_term(vmul(vm(M_LLAST), vsub(e_val(zx), vc(1))))

    def compress_v(tup):
        acc = None
        for e in tup:
            ev = expr_v(e)
            acc = ev if acc is None else vadd(vmul(acc, vm(CH["theta"])), ev)
        return acc if acc is not None else vc(0)

    # scratch: T0-T2 for tpb/prodF/sumExc, T3-T4 for the <=2 compressed
    # inputs (M_IE slots 0x4a0+ stay live — lookup exprs may read them)
    S_TPB, S_PRODF, S_SUMEXC = M_T0, M_T1, M_T2
    S_F = M_T3
    for li, lk in enumerate(cs.lookups):
        phx, phwx, mx = f"phi{li}@0", f"phi{li}@1", f"lkm{li}@0"
        nf = len(lk.inputs)
        assert nf <= 2, "lookup input scratch exhausted"
        vadd(compress_v(lk.table), vm(CH["beta"]))()
        store(S_TPB)
        for fi, tup in enumerate(lk.inputs):
            vadd(compress_v(tup), vm(CH["beta"]))()
            store(S_F + 32 * fi)
        prodf = vm(S_F)
        for fi in range(1, nf):
            prodf = vmul(prodf, vm(S_F + 32 * fi))
        prodf()
        store(S_PRODF)
        if nf == 1:
            A.push(1)
        else:
            se = None
            for kk in range(nf):
                pr = None
                for jj in range(nf):
                    if jj == kk:
                        continue
                    t = vm(S_F + 32 * jj)
                    pr = t if pr is None else vmul(pr, t)
                se = pr if se is None else vadd(se, pr)
            se()
        store(S_SUMEXC)
        lhs = vmul(vmul(vsub(e_val(phwx), e_val(phx)), vm(S_PRODF)),
                   vm(S_TPB))
        rhs = vsub(vmul(vm(S_TPB), vm(S_SUMEXC)),
                   vmul(e_val(mx), vm(S_PRODF)))
        acc_term(vmul(vm(M_NOTLAST), vsub(lhs, rhs)))
        acc_term(vmul(vm(M_L0), e_val(phx)))
        acc_term(vmul(vm(M_LLAST), e_val(phx)))

    for si, sh in enumerate(cs.shuffles):
        zx, zwx = f"shz{si}@0", f"shz{si}@1"
        vadd(compress_v(sh.input), vm(CH["gamma"]))()
        store(M_T0)                   # ax
        vadd(compress_v(sh.table), vm(CH["gamma"]))()
        store(M_T1)                   # bx
        acc_term(vmul(vm(M_NOTLAST), vsub(vmul(e_val(zwx), vm(M_T1)),
                                          vmul(e_val(zx), vm(M_T0)))))
        acc_term(vmul(vm(M_L0), vsub(e_val(zx), vc(1))))
        acc_term(vmul(vm(M_LLAST), vsub(e_val(zx), vc(1))))

    # quotient identity: total == zh * Horner(h, xn)
    hx = vc(0)
    for i in range(nh - 1, -1, -1):
        hx = vadd(vmul(hx, vm(M_XN)), e_val(f"h{i}@0"))
    vmul(vm(M_ZH), hx)()
    load(M_TOTAL)
    A.op(EQ)
    okq = lbl("quot")
    A.jumpi(okq)
    ret_bool(0)
    A.label(okq)

    # ---------- multiopen ----------
    def vc_raw(x):
        """Push an UNREDUCED constant (Fq point coordinates)."""
        return lambda: A.push(int(x))

    def push_comm_xy(src):
        """(vx, vy) emitters for a commitment source."""
        kind = src[0]
        if kind in ("adv", "permz", "phi", "m", "shz", "rand", "h"):
            i = src[1] if len(src) > 1 else 0
            o = off[kind] + 64 * i
            return vcd(o), vcd(o + 32)
        if kind == "fix":
            pt = vk.fixed_commitments[src[1]]
        elif kind == "sigma":
            pt = vk.sigma_commitments[src[1]]
        else:
            raise KeyError(src)
        x, y = (0, 0) if pt is None else pt
        return vc_raw(x), vc_raw(y)

    for gi, rot in enumerate(rotations):
        if rot == 0:
            load(CH["x"])
        else:
            rot_om = pow(omega, rot, P) if rot >= 0 else pow(
                pow(omega, -1, P), -rot, P)
            vmul(vm(CH["x"]), vc(rot_om))()
        store(M_PTS + 32 * gi)

        for ii, (src, lab) in enumerate(groups[rot]):
            vx, vy = push_comm_xy(src)
            evi = lab_idx[lab]
            if ii == 0:
                vx(); store(M_CX + 32 * gi)
                vy(); store(M_CY + 32 * gi)
                load(M_E + 32 * evi)
                store(M_VV + 32 * gi)
            else:
                # g = ecAdd(ecMul(g, v), comm)
                sub_call("ecmul", vm(CH["v"]), vm(M_CY + 32 * gi),
                         vm(M_CX + 32 * gi))
                sub_call("ecadd", vy, vx, vm(M_POUT + 0x20), vm(M_POUT))
                load(M_POUT)
                store(M_CX + 32 * gi)
                load(M_POUT + 0x20)
                store(M_CY + 32 * gi)
                vadd(vmul(vm(M_VV + 32 * gi), vm(CH["v"])),
                     vm(M_E + 32 * evi))()
                store(M_VV + 32 * gi)

    # ord = identity; insertion-sort network on point values
    for i in range(n_open):
        A.push(i)
        store(M_ORD + 32 * i)
    for i in range(1, n_open):
        for j in range(i, 0, -1):
            skip = lbl("srt")
            # if pts[ord[j-1]] <= pts[ord[j]]: skip swap
            def pts_of_ord(jj):
                load(M_ORD + 32 * jj)
                A.push(32)
                A.op(MUL)
                A.push(M_PTS)
                A.op(ADD, MLOAD)
            pts_of_ord(j)                 # pts[ord[j]]
            pts_of_ord(j - 1)             # pts[ord[j-1]] (top)
            A.op(GT)                      # ord[j-1] > ord[j] ?
            A.op(ISZERO)
            A.jumpi(skip)
            load(M_ORD + 32 * (j - 1))
            load(M_ORD + 32 * j)
            store(M_ORD + 32 * (j - 1))
            store(M_ORD + 32 * j)
            A.label(skip)

    # accumulation loop (unrolled): up = 1, L = R = identity
    A.push(1); store(M_UP)
    A.push(0); store(M_LX)
    A.push(0); store(M_LY)
    A.push(0); store(M_RX)
    A.push(0); store(M_RY)

    def arr_at_ord(base):
        """[] -> push arr[ord_gi] where ord_gi in M_T0"""
        load(M_T0)
        A.push(32)
        A.op(MUL)
        A.push(base)
        A.op(ADD, MLOAD)

    for oi in range(n_open):
        load(M_ORD + 32 * oi)
        store(M_T0)                       # gi
        wo = off["open"] + 64 * oi
        # t = ecMul(W, pts[gi]) + C[gi] + ecMul(G, -vv[gi]) ; scaled by up
        sub_call("ecmul", lambda: arr_at_ord(M_PTS), vcd(wo + 32), vcd(wo))
        load(M_POUT); store(M_T1)
        load(M_POUT + 0x20); store(M_T2)
        sub_call("ecadd", lambda: arr_at_ord(M_CY), lambda: arr_at_ord(M_CX),
                 vm(M_T2), vm(M_T1))
        load(M_POUT); store(M_T1)
        load(M_POUT + 0x20); store(M_T2)
        # -vv[gi] mod P
        def neg_vv():
            A.push(P)
            arr_at_ord(M_VV)
            A.op(SWAP1, SUB)
            A.push(P)
            A.op(SWAP1, MOD)
        sub_call("ecmul", neg_vv, vc_raw(2), vc_raw(1))
        sub_call("ecadd", vm(M_POUT + 0x20), vm(M_POUT), vm(M_T2), vm(M_T1))
        load(M_POUT); store(M_T1)
        load(M_POUT + 0x20); store(M_T2)
        sub_call("ecmul", vm(M_UP), vm(M_T2), vm(M_T1))
        sub_call("ecadd", vm(M_RY), vm(M_RX), vm(M_POUT + 0x20), vm(M_POUT))
        load(M_POUT); store(M_RX)
        load(M_POUT + 0x20); store(M_RY)
        # L += up * W
        sub_call("ecmul", vm(M_UP), vcd(wo + 32), vcd(wo))
        sub_call("ecadd", vm(M_LY), vm(M_LX), vm(M_POUT + 0x20), vm(M_POUT))
        load(M_POUT); store(M_LX)
        load(M_POUT + 0x20); store(M_LY)
        # up *= u
        vmul(vm(M_UP), vm(CH["u"]))()
        store(M_UP)

    # negate R unless identity: ry = Q - ry
    skipneg = lbl("neg")
    load(M_RX)
    load(M_RY)
    A.op(0x17)                        # OR
    A.op(ISZERO)
    A.jumpi(skipneg)
    A.push(Q)
    load(M_RY)
    A.op(SWAP1, SUB)
    store(M_RY)
    A.label(skipneg)

    # pairing input: (L, sG2), (−R, G2); G2 words are (x1, x0, y1, y0)
    g2x, g2y = g2
    sg2x, sg2y = s_g2
    load(M_LX); store(0x000)
    load(M_LY); store(0x020)
    A.push(int(sg2x[1])); store(0x040)
    A.push(int(sg2x[0])); store(0x060)
    A.push(int(sg2y[1])); store(0x080)
    A.push(int(sg2y[0])); store(0x0A0)
    load(M_RX); store(0x0C0)
    load(M_RY); store(0x0E0)
    A.push(int(g2x[1])); store(0x100)
    A.push(int(g2x[0])); store(0x120)
    A.push(int(g2y[1])); store(0x140)
    A.push(int(g2y[0])); store(0x160)
    A.push(32); A.push(M_POUT); A.push(0x180); A.push(0)
    A.push(0x08); A.op(GAS, STATICCALL)
    require()
    load(M_POUT)
    A.push(1)
    A.op(EQ)
    okp = lbl("pair")
    A.jumpi(okp)
    ret_bool(0)
    A.label(okp)
    ret_bool(1)

    emit_subroutines()
    return A.assemble()
