"""A minimal EVM interpreter — the in-repo devnet analog (copy of
`ezkl_tpu/evm/vm.py`; its precompiles run on the port's own host crypto).

The reference executes its generated Solidity verifiers on an anvil devnet
(`ezkl/src/eth.rs:124,162,238`; 23 models in
`tests/integration_tests.rs:299-323`). Without solc, anvil or a network,
the on-chain path is closed differently: the EVM artifact is emitted
directly as BYTECODE (`ezkl_tpu_torch.evm.bytecode`) and
executed here on a faithful interpreter of the EVM's execution model —
stack machine, byte-addressed memory, calldata, keccak, JUMPDEST-validated
jumps, and the BN254 + modexp precompiles of EIP-196/197/198 backed by the
repo's own host crypto (`fieldmath/hostcurve.py`, `plonk/pairing.py`,
`native/host_crypto.cpp` when built).

Deliberately NOT implemented: gas accounting (a `gas` counter exists only
so GAS pushes something), logs, create2, selfdestruct, and the
contract-call value plumbing — none of which a `view` verifier touches.
"""

from __future__ import annotations

import dataclasses

from ..utils.keccak import keccak256

U256 = (1 << 256) - 1
_SIGN = 1 << 255


class EvmRevert(Exception):
    def __init__(self, data: bytes = b""):
        super().__init__(f"revert: {data[:64].hex()}")
        self.data = data


class EvmError(Exception):
    """Invalid operation (bad jump, stack underflow, invalid opcode) —
    consumes all gas on a real chain; here it just fails the call."""


@dataclasses.dataclass
class _Ctx:
    code: bytes
    calldata: bytes
    static: bool


class EVM:
    """World state: address -> runtime code. Storage exists per address but
    the verifier artifacts never use it."""

    def __init__(self):
        self.code: dict[int, bytes] = {}
        self.storage: dict[int, dict[int, int]] = {}
        self._next_addr = 0x1000

    # -- deployment ---------------------------------------------------------

    def deploy(self, initcode: bytes, addr: int | None = None) -> int:
        """Run constructor code; the RETURNed bytes become the runtime code."""
        runtime = self._exec(_Ctx(bytes(initcode), b"", static=False))
        if addr is None:
            addr = self._next_addr
            self._next_addr += 1
        self.code[addr] = bytes(runtime)
        return addr

    def deploy_runtime(self, runtime: bytes, addr: int | None = None) -> int:
        """Install runtime code directly (skip constructor)."""
        if addr is None:
            addr = self._next_addr
            self._next_addr += 1
        self.code[addr] = bytes(runtime)
        return addr

    # -- calls --------------------------------------------------------------

    def call(self, addr: int, calldata: bytes = b"", static: bool = True) -> bytes:
        if 1 <= addr <= 9:
            return _precompile(addr, bytes(calldata))
        code = self.code.get(addr)
        if code is None:
            return b""
        return self._exec(_Ctx(code, bytes(calldata), static))

    # -- the interpreter ----------------------------------------------------

    def _exec(self, ctx: _Ctx) -> bytes:  # noqa: C901 (a VM is one big switch)
        code = ctx.code
        stack: list[int] = []
        mem = bytearray()
        pc = 0
        retdata = b""
        jumpdests = _jumpdests(code)

        def push(v):
            if len(stack) >= 1024:
                raise EvmError("stack overflow")
            stack.append(v & U256)

        def pop():
            try:
                return stack.pop()
            except IndexError:
                raise EvmError("stack underflow") from None

        def mgrow(off, size):
            if size == 0:
                return
            end = (off + size + 31) // 32 * 32
            if end > len(mem):
                mem.extend(b"\x00" * (end - len(mem)))

        def mread(off, size):
            mgrow(off, size)
            return bytes(mem[off:off + size])

        def mwrite(off, data):
            mgrow(off, len(data))
            mem[off:off + len(data)] = data

        while pc < len(code):
            op = code[pc]
            pc += 1
            if 0x60 <= op <= 0x7F:                       # PUSH1..PUSH32
                nbytes = op - 0x5F
                push(int.from_bytes(code[pc:pc + nbytes], "big"))
                pc += nbytes
            elif op == 0x5F:                             # PUSH0
                push(0)
            elif 0x80 <= op <= 0x8F:                     # DUP1..16
                i = op - 0x7F
                if len(stack) < i:
                    raise EvmError("stack underflow")
                push(stack[-i])
            elif 0x90 <= op <= 0x9F:                     # SWAP1..16
                i = op - 0x8F
                if len(stack) < i + 1:
                    raise EvmError("stack underflow")
                stack[-1], stack[-1 - i] = stack[-1 - i], stack[-1]
            elif op == 0x00:                             # STOP
                return b""
            elif op == 0x01:
                push(pop() + pop())
            elif op == 0x02:
                push(pop() * pop())
            elif op == 0x03:
                a, b = pop(), pop()
                push(a - b)
            elif op == 0x04:
                a, b = pop(), pop()
                push(a // b if b else 0)
            elif op == 0x06:                             # MOD
                a, b = pop(), pop()
                push(a % b if b else 0)
            elif op == 0x08:                             # ADDMOD
                a, b, m = pop(), pop(), pop()
                push((a + b) % m if m else 0)
            elif op == 0x09:                             # MULMOD
                a, b, m = pop(), pop(), pop()
                push((a * b) % m if m else 0)
            elif op == 0x0A:                             # EXP
                a, b = pop(), pop()
                push(pow(a, b, 1 << 256))
            elif op == 0x10:                             # LT
                a, b = pop(), pop()
                push(1 if a < b else 0)
            elif op == 0x11:                             # GT
                a, b = pop(), pop()
                push(1 if a > b else 0)
            elif op == 0x12:                             # SLT
                a, b = pop(), pop()
                sa = a - (1 << 256) if a & _SIGN else a
                sb = b - (1 << 256) if b & _SIGN else b
                push(1 if sa < sb else 0)
            elif op == 0x14:                             # EQ
                push(1 if pop() == pop() else 0)
            elif op == 0x15:                             # ISZERO
                push(1 if pop() == 0 else 0)
            elif op == 0x16:
                push(pop() & pop())
            elif op == 0x17:
                push(pop() | pop())
            elif op == 0x18:
                push(pop() ^ pop())
            elif op == 0x19:
                push(~pop())
            elif op == 0x1A:                             # BYTE
                i, v = pop(), pop()
                push((v >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:                             # SHL
                s, v = pop(), pop()
                push(v << s if s < 256 else 0)
            elif op == 0x1C:                             # SHR
                s, v = pop(), pop()
                push(v >> s if s < 256 else 0)
            elif op == 0x20:                             # KECCAK256
                off, size = pop(), pop()
                push(int.from_bytes(keccak256(mread(off, size)), "big"))
            elif op == 0x34:                             # CALLVALUE
                push(0)
            elif op == 0x35:                             # CALLDATALOAD
                off = pop()
                push(int.from_bytes(
                    ctx.calldata[off:off + 32].ljust(32, b"\x00"), "big"))
            elif op == 0x36:                             # CALLDATASIZE
                push(len(ctx.calldata))
            elif op == 0x37:                             # CALLDATACOPY
                doff, soff, size = pop(), pop(), pop()
                chunk = ctx.calldata[soff:soff + size].ljust(size, b"\x00")
                mwrite(doff, chunk)
            elif op == 0x38:                             # CODESIZE
                push(len(code))
            elif op == 0x39:                             # CODECOPY
                doff, soff, size = pop(), pop(), pop()
                mwrite(doff, code[soff:soff + size].ljust(size, b"\x00"))
            elif op == 0x3B:                             # EXTCODESIZE
                push(len(self.code.get(pop(), b"")))
            elif op == 0x3C:                             # EXTCODECOPY
                a, doff, soff, size = pop(), pop(), pop(), pop()
                c = self.code.get(a, b"")
                mwrite(doff, c[soff:soff + size].ljust(size, b"\x00"))
            elif op == 0x3D:                             # RETURNDATASIZE
                push(len(retdata))
            elif op == 0x3E:                             # RETURNDATACOPY
                doff, soff, size = pop(), pop(), pop()
                if soff + size > len(retdata):
                    raise EvmError("returndata out of bounds")
                mwrite(doff, retdata[soff:soff + size])
            elif op == 0x50:                             # POP
                pop()
            elif op == 0x51:                             # MLOAD
                push(int.from_bytes(mread(pop(), 32), "big"))
            elif op == 0x52:                             # MSTORE
                off, v = pop(), pop()
                mwrite(off, v.to_bytes(32, "big"))
            elif op == 0x53:                             # MSTORE8
                off, v = pop(), pop()
                mwrite(off, bytes([v & 0xFF]))
            elif op == 0x54:                             # SLOAD
                push(self.storage.setdefault(id(ctx), {}).get(pop(), 0))
            elif op == 0x55:                             # SSTORE
                if ctx.static:
                    raise EvmError("SSTORE in static context")
                k, v = pop(), pop()
                self.storage.setdefault(id(ctx), {})[k] = v
            elif op == 0x56:                             # JUMP
                dest = pop()
                if dest not in jumpdests:
                    raise EvmError(f"bad jump {dest}")
                pc = dest
            elif op == 0x57:                             # JUMPI
                dest, cond = pop(), pop()
                if cond:
                    if dest not in jumpdests:
                        raise EvmError(f"bad jump {dest}")
                    pc = dest
            elif op == 0x58:                             # PC
                push(pc - 1)
            elif op == 0x59:                             # MSIZE
                push(len(mem))
            elif op == 0x5A:                             # GAS
                push(10**9)
            elif op == 0x5B:                             # JUMPDEST
                pass
            elif op in (0xF1, 0xFA):                     # CALL / STATICCALL
                if op == 0xF1:
                    _gas, addr, _val, aoff, asz, roff, rsz = (
                        pop(), pop(), pop(), pop(), pop(), pop(), pop())
                else:
                    _gas, addr, aoff, asz, roff, rsz = (
                        pop(), pop(), pop(), pop(), pop(), pop())
                args = mread(aoff, asz)
                try:
                    retdata = self.call(addr, args,
                                        static=(op == 0xFA or ctx.static))
                    ok = 1
                except (EvmRevert, EvmError, ValueError):
                    retdata = b""
                    ok = 0
                if retdata[:rsz]:
                    mwrite(roff, retdata[:rsz])
                push(ok)
            elif op == 0xF3:                             # RETURN
                off, size = pop(), pop()
                return mread(off, size)
            elif op == 0xFD:                             # REVERT
                off, size = pop(), pop()
                raise EvmRevert(mread(off, size))
            else:
                raise EvmError(f"invalid opcode 0x{op:02x} at {pc - 1}")
        return b""


def _jumpdests(code: bytes) -> set[int]:
    out = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            out.add(i)
        i += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    return out


# ---------------------------------------------------------------------------
# precompiles (EIP-196/197/198)
# ---------------------------------------------------------------------------

def _precompile(addr: int, data: bytes) -> bytes:
    from ..fieldmath import hostcurve as hc
    from ..fieldmath.spec import FQ_MODULUS, FR_MODULUS
    from ..plonk import pairing

    def word(i):
        return int.from_bytes(data[32 * i:32 * i + 32].ljust(32, b"\x00"), "big")

    if addr == 0x04:                                    # identity
        return data
    if addr == 0x05:                                    # modexp
        blen, elen, mlen = word(0), word(1), word(2)
        o = 96
        b = int.from_bytes(data[o:o + blen].ljust(blen, b"\x00"), "big")
        e = int.from_bytes(data[o + blen:o + blen + elen].ljust(elen, b"\x00"), "big")
        m = int.from_bytes(
            data[o + blen + elen:o + blen + elen + mlen].ljust(mlen, b"\x00"), "big")
        r = pow(b, e, m) if m else 0
        return r.to_bytes(mlen, "big") if mlen else b""

    def g1_in(x, y):
        if x == 0 and y == 0:
            return None
        if x >= FQ_MODULUS or y >= FQ_MODULUS or not hc.g1_is_on_curve((x, y)):
            raise ValueError("invalid G1 point")
        return (x, y)

    def g1_out(p):
        if p is None:
            return b"\x00" * 64
        return int(p[0]).to_bytes(32, "big") + int(p[1]).to_bytes(32, "big")

    if addr == 0x06:                                    # ecAdd
        return g1_out(hc.g1_add(g1_in(word(0), word(1)),
                                g1_in(word(2), word(3))))
    if addr == 0x07:                                    # ecMul
        return g1_out(hc.g1_mul(g1_in(word(0), word(1)), word(2)))
    if addr == 0x08:                                    # ecPairing
        if len(data) % 192:
            raise ValueError("pairing input not multiple of 192")
        pairs = []
        for i in range(len(data) // 192):
            b6 = [word(6 * i + j) for j in range(6)]
            p1 = g1_in(b6[0], b6[1])
            # EIP-197 G2 word order: x_c1, x_c0, y_c1, y_c0
            x1, x0, y1, y0 = b6[2], b6[3], b6[4], b6[5]
            if max(x0, x1, y0, y1) >= FQ_MODULUS:
                raise ValueError("invalid G2 coord")
            q2 = None if (x0 | x1 | y0 | y1) == 0 else ((x0, x1), (y0, y1))
            if p1 is None or q2 is None:
                continue
            pairs.append((p1, q2))
        ok = pairing.pairing_check(pairs) if pairs else True
        return int(ok).to_bytes(32, "big")
    raise ValueError(f"unsupported precompile 0x{addr:02x}")
