"""BN254 Montgomery arithmetic on PyTorch tensors.

Layout: a field array is a `(8, *batch)` `torch.int32` tensor holding the
u32 bit patterns of eight little-endian 32-bit limbs, limb axis first, in
Montgomery form with R = 2^256 and canonical (< p). That is exactly
`ezkl_tpu.kernels.msm._pack2` of the JAX package's `(16, *batch)` 16-bit
limbs, so the two packages hold the same Montgomery integers
(`ezkl_tpu_torch.convert` carries arrays across). int32 rather than uint32:
torch's uint32 lacks add, shift and compare on the CPU.

Dispatch. `mont_mul` is kernel K1: a CUDA tensor always goes through the
hand-written kernel (`csrc/field.cu`, built by `kernels/build.py`), a CPU
tensor through `mont_mul_plain`. K1's chain forms do the same for the two
chains of products the prover runs: `pow_static` (and so `inv`) through
`ez_mont_pow` or `pow_static_plain`, the sequential block scan of
`prefix_scan_mul` through `ez_mont_scan` or `seq_scan_mul_plain`; on the
card each chain is one launch, not one per product. Field add, sub, neg and
select were XLA ops in the JAX package, not TPU kernels; here they are plain
torch ops on either device.

Plain versions compute on int64 tensors: 32-bit limbs ("words") for add and
sub, 16-bit limbs for the product, where every partial product and column sum
is exact. Carries resolve in one pass: the carry out of limb k is the
generate bit of the last limb at or below k that does not propagate, found
with one `cummax` -- a few large ops instead of a loop over limbs. On a CPU
tensor the product runs instead on float64 columns of 16-bit weight, exact
integers below 2^53, with one sequential carry pass (`_mont_mul_w`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..kernels import build
from .spec import FieldSpec, NWORDS, WORD_BITS, WORD_MASK, int_to_words

DEFAULT_DEVICE = "cuda"
M32 = WORD_MASK
M16 = 0xFFFF
_FIELD_ID = {"bn254_fr": 0, "bn254_fq": 1}


def device_of(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------

def _ints_to_words(ints: list[int], p: int) -> np.ndarray:
    """Ints -> (8, n) uint32 words of their residues mod p, from one run of
    32-byte little-endian forms."""
    buf = b"".join([(v % p).to_bytes(32, "little") for v in ints])
    return np.frombuffer(buf, np.uint32).reshape(len(ints), NWORDS).T.copy()


def _words_to_ints(a: np.ndarray) -> np.ndarray:
    """(8, n) uint32 words -> object array of ints."""
    v = np.zeros(a.shape[1], dtype=object)
    for i in range(NWORDS - 1, -1, -1):
        v = (v << WORD_BITS) | a[i].astype(np.uint64).astype(object)
    return v


def host_words(limbs) -> np.ndarray:
    """Tensor or array of limbs -> host numpy uint32 (same shape)."""
    if isinstance(limbs, torch.Tensor):
        return limbs.detach().cpu().contiguous().numpy().view(np.uint32)
    return np.asarray(limbs, dtype=np.uint32)


def to_device(words: np.ndarray, device=None) -> torch.Tensor:
    """Host uint32 words -> int32 tensor on `device`."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device_of(device))


def encode(spec: FieldSpec, xs, mont: bool = True) -> np.ndarray:
    """Ints of any sign and size (any nested shape) -> host (8, *shape)
    uint32 words of their residues mod p (in Montgomery form if `mont`)."""
    arr = np.asarray(xs, dtype=object)
    ints = list(map(int, arr.reshape(-1).tolist()))
    if mont:
        ints = [v * spec.r for v in ints]
    return _ints_to_words(ints, spec.modulus).reshape((NWORDS,) + arr.shape)


def decode(spec: FieldSpec, limbs, mont: bool = True) -> np.ndarray:
    """(8, *shape) limbs (tensor or array) -> object ndarray of ints."""
    a = host_words(limbs)
    batch = a.shape[1:]
    v = _words_to_ints(a.reshape(NWORDS, -1))
    rinv = pow(spec.r, -1, spec.modulus) if mont else 1
    return ((v * rinv) % spec.modulus).reshape(batch)


@functools.lru_cache(maxsize=None)
def _i64_words(spec: FieldSpec):
    """p mod 2^64, and the (6, 2) words 2-7 of p - |x| for a negative int64
    x: column 0 for |x| <= p mod 2^64, column 1 (one borrowed) above it."""
    hi = spec.modulus >> 64
    return np.uint64(spec.modulus % (1 << 64)), np.array(
        [[(h >> (WORD_BITS * i)) & M32 for h in (hi, hi - 1)]
         for i in range(NWORDS - 2)], np.uint32)


def encode_i64(spec: FieldSpec, xs, out=None) -> np.ndarray:
    """int64 ndarray -> host (8, *shape) RAW (non-Montgomery) words;
    negative values map to p - |x|. Written into `out`, an (8, *shape)
    uint32 array or view, when one is given.

    No Python ints: an x >= 0 is its own two low words, the rest zero. For
    x < 0, |x| <= 2^63 < p, and p - |x| = (p mod 2^64) + x mod 2^64 in the
    low 64 bits, over p's words 2-7 less the borrow that |x| > p mod 2^64
    takes from them; that borrow is there exactly when the 64-bit sum does
    not wrap, i.e. comes out at or above p mod 2^64."""
    xs = np.asarray(xs, dtype=np.int64)
    if out is None:
        out = np.empty((NWORDS,) + xs.shape, np.uint32)
    out[2:] = 0
    neg = xs < 0
    lo = xs.view(np.uint64)
    if neg.any():
        p_lo, hi = _i64_words(spec)
        lo = lo.copy()
        lo[neg] += p_lo
        out[2:, neg] = hi[:, (lo[neg] >= p_lo).view(np.uint8)]
    out[0] = lo & M32
    out[1] = lo >> WORD_BITS
    return out


def pack_rows(a) -> np.ndarray:
    """(8, n) RAW words -> (n,) structured 4 x u64 array for host set
    operations (sort / searchsorted); its lexicographic order is a consistent
    total order, which is all matching needs."""
    a = np.asarray(host_words(a), np.uint64)
    n = a.shape[-1]
    out = np.zeros((n, 4), np.uint64)
    for i in range(NWORDS):
        out[:, i // 2] |= a[i] << np.uint64(WORD_BITS * (i % 2))
    return np.ascontiguousarray(out).view([("", np.uint64)] * 4).reshape(-1)


def pack_rows_multi(blocks) -> np.ndarray:
    """List of (8, n) RAW word arrays (a tuple of values per row) -> (n,)
    structured array over 4*len(blocks) u64 fields (row-wise tuples); the
    same u64 values as the JAX package's, which packs 16-bit limbs."""
    packed = np.concatenate([pack_rows(a).view(np.uint64).reshape(-1, 4)
                             for a in blocks], axis=1)
    return np.ascontiguousarray(packed).view(
        [("", np.uint64)] * (4 * len(blocks))).reshape(-1)


@functools.lru_cache(maxsize=4096)
def _const_cached(spec: FieldSpec, value: int, mont: bool, device: str):
    return to_device(encode(spec, [value], mont=mont)[:, 0], device)


def const(spec: FieldSpec, value: int, mont: bool = True, device=None) -> torch.Tensor:
    """A field constant as an (8,) limb vector."""
    return _const_cached(spec, int(value) % spec.modulus, mont, str(device_of(device)))


def bcast_const(spec: FieldSpec, value: int, batch_ndim: int, mont: bool = True,
                device=None) -> torch.Tensor:
    """Constant shaped (8, 1, ..., 1) for broadcasting against batch dims."""
    return const(spec, value, mont, device).reshape((NWORDS,) + (1,) * batch_ndim)


def zeros(batch_shape, device=None) -> torch.Tensor:
    return torch.zeros((NWORDS,) + tuple(batch_shape), dtype=torch.int32,
                       device=device_of(device))


def ones_mont(spec: FieldSpec, batch_shape, device=None) -> torch.Tensor:
    batch_shape = tuple(batch_shape)
    one = bcast_const(spec, 1, len(batch_shape), device=device)
    return one.expand((NWORDS,) + batch_shape)


# ---------------------------------------------------------------------------
# plain core: int64 words / 16-bit limbs
# ---------------------------------------------------------------------------

def _w(t: torch.Tensor) -> torch.Tensor:
    """int32 limbs -> int64 words in [0, 2^32)."""
    return t.long() & M32


def _i32(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 bit patterns."""
    return (w - ((w >> 31) << WORD_BITS)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _limb_positions(k: int, ndim: int, device: str) -> torch.Tensor:
    return torch.arange(k, device=device).reshape((k,) + (1,) * (ndim - 1))


def _carries(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry (or borrow) out of each limb along axis 0, in the encoding of
    `gen` (bool, or int64 -1/0 for borrows): c_k = gen_k | (prop_k & c_{k-1}).
    It is gen at the last limb <= k that does not propagate (limb 0 if all
    do: then gen_0 is 0)."""
    pos = _limb_positions(gen.shape[0], gen.dim(), str(gen.device))
    last = torch.cummax(torch.where(prop, 0, pos), dim=0).values
    return torch.gather(gen, 0, last)


def _norm_words(s: torch.Tensor) -> torch.Tensor:
    """Words < 2^33 - 1 -> normalized words (top carry dropped; `s` is
    consumed)."""
    c = _carries(s > M32, s == M32)
    s[1:] += c[:-1]
    return s & M32


@functools.lru_cache(maxsize=None)
def _p_words(spec: FieldSpec, device: str) -> torch.Tensor:
    return torch.tensor([int(x) for x in int_to_words(spec.modulus)],
                        dtype=torch.int64, device=device)


def _pw(spec, like):
    return _p_words(spec, str(like.device)).reshape((NWORDS,) + (1,) * (like.dim() - 1))


def _cond_sub_w(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Normalized words < 2p -> canonical (< p)."""
    d = a - _pw(spec, a)
    b = _carries(d >> 63, d == 0)          # -1 where a borrow leaves the limb
    d[1:] += b[:-1]
    return torch.where(b[-1] < 0, a, d & M32)


def add_w(spec: FieldSpec, a, b):
    return _cond_sub_w(spec, _norm_words(a + b))


def sub_w(spec: FieldSpec, a, b):
    d = a - b
    bo = _carries(d >> 63, d == 0)
    d[1:] += bo[:-1]
    d &= M32
    return torch.where(bo[-1] < 0, _norm_words(d + _pw(spec, d)), d)


def _to16(w: torch.Tensor) -> torch.Tensor:
    """(8, n) words -> (16, n) 16-bit limbs."""
    return torch.stack([w & M16, w >> 16], dim=1).reshape(16, -1)


def _split(v: torch.Tensor, rounds: int) -> torch.Tensor:
    """Split passes over columns of 16-bit weight (mod 2^(16K): the part of
    the top column above 16 bits is dropped). Each pass maps a bound B to
    2^16 - 1 + B / 2^16. `v` is consumed."""
    for _ in range(rounds):
        hi = v >> 16
        v &= M16
        v[1:] += hi[:-1]
    return v


def _norm16(v: torch.Tensor, rounds: int) -> torch.Tensor:
    """Columns of 16-bit weight -> normalized 16-bit limbs mod 2^(16K).
    `rounds` split passes bring every column to <= 2^17 - 2 (carries 0/1)
    before the one carry pass. `v` is consumed."""
    v = _split(v, rounds)
    c = _carries(v > M16, v == M16)
    v[1:] += c[:-1]
    return v & M16


def _toeplitz(c16, rows: int) -> torch.Tensor:
    """(rows, 16) float64 matrix M[k, j] = c16[k - j]: M @ x is the product
    of the constant with 16-bit limbs x, by columns."""
    m = torch.zeros(rows, 16, dtype=torch.float64)
    for j in range(16):
        for k in range(j, min(rows, j + 16)):
            m[k, j] = float(c16[k - j])
    return m


@functools.lru_cache(maxsize=None)
def _mul_tables(spec: FieldSpec, device: str):
    """Index map of the limb-by-word product and the float64 Toeplitz
    matrices of N' = -p^-1 mod R and of p."""
    i = torch.arange(16).repeat_interleave(NWORDS)        # 16-bit limb of a
    j = torch.arange(NWORDS).repeat(16)                   # 32-bit word of b
    nprime = pow(-spec.modulus, -1, 1 << 256) % (1 << 256)
    np16 = [(nprime >> (16 * k)) & M16 for k in range(16)]
    p16 = [(spec.modulus >> (16 * k)) & M16 for k in range(16)]
    dev = torch.device(device)
    return dict(cols=(i + 2 * j).to(dev), np_mat=_toeplitz(np16, 16).to(dev),
                p_mat=_toeplitz(p16, 32).to(dev))


def _mont_mul_int64(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Words (8, n) x words (8, n) -> canonical Montgomery product words, on
    int64 16-bit limbs (the card's plain product).

    Separated reduction as the JAX package's `_mont_mul_stacked`:
    T = a*b; m = (T mod R) * N' mod R; (T + m*p) / R, one conditional
    subtraction. T sums 16-bit limbs of a times 32-bit words of b into 31
    columns of 16-bit weight (< 8 * 2^48 = 2^51). The two products by a
    constant are float64 matrix products, exact because every entry and
    partial sum stays below 2^53: N' times T mod R split to limbs < 2^17
    (< 2^37), and p times m (< 2^36)."""
    tb = _mul_tables(spec, str(a.device))
    n = a.shape[1]
    T = torch.zeros(32, n, dtype=torch.int64, device=a.device)
    T.index_add_(0, tb["cols"], (_to16(a)[:, None, :] * b[None, :, :]).reshape(16 * NWORDS, n))
    t_lo = _split(T[:16].clone(), rounds=3)
    m = _norm16((tb["np_mat"] @ t_lo.double()).long(), rounds=2)
    T += (tb["p_mat"] @ m.double()).long()
    s = _norm16(T, rounds=3)[16:]
    return _cond_sub_w(spec, s[0::2] | (s[1::2] << 16))


@functools.lru_cache(maxsize=None)
def _f64_tables(spec: FieldSpec, device: str):
    """The float64 matrices of the reduction. `np_mat` (16 x 16): the
    columns of N' = -p^-1 mod R times 16-bit limbs, mod R. `p_mat` (17 x 16):
    row 0 takes limb j of m times p's part below R, scaled by 2^-256 (its
    share of the carry into column 16); rows 1-16 are columns 16-31 of p
    times m. `lo_scale`: the weights 2^(16k - 256) of columns 0-15."""
    nprime = pow(-spec.modulus, -1, 1 << 256)
    np16 = [(nprime >> (16 * k)) & M16 for k in range(16)]
    p16 = [(spec.modulus >> (16 * k)) & M16 for k in range(16)]
    np_mat = torch.zeros(16, 16, dtype=torch.float64)
    p_mat = torch.zeros(17, 16, dtype=torch.float64)
    for j in range(16):
        for k in range(j, 16):
            np_mat[k, j] = np16[k - j]
        p_mat[0, j] = (spec.modulus % (1 << (256 - 16 * j))) / 2.0 ** (256 - 16 * j)
        for k in range(16, 16 + j):
            p_mat[k - 15, j] = p16[k - j]
    lo_scale = torch.tensor([2.0 ** (16 * k - 256) for k in range(16)], dtype=torch.float64)
    return np_mat.to(device), p_mat.to(device), lo_scale.to(device)


# lanes a product works on at once: a block's 32 float64 columns (2 MiB) stay
# in a core's L2 cache; a product of 2^18 lanes in one block took 2-3x as long
_BLOCK = 8192


def _carry16(v: torch.Tensor) -> torch.Tensor:
    """Float64 columns of 16-bit weight, integers < 2^52 -> 16-bit limbs
    mod 2^(16 * rows), in one carry pass (`v` is consumed)."""
    rows = v.unbind(0)
    for lo, hi in zip(rows, rows[1:]):
        hi += torch.floor(lo * 2.0 ** -16)
    return v - torch.floor(v * 2.0 ** -16) * 65536.0


def _mont_mul_block(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_mont_mul_int64`'s product on float64 columns (the CPU's).

    Separated reduction as the JAX package's `_mont_mul_stacked`:
    T = a*b; m = T * N' mod R; (T + m*p) / R, one conditional subtraction,
    on 32 float64 columns of 16-bit weight. Every value stays an integer
    under 2^53, so every product, sum and split below is exact:
    - T: 16-bit limbs of a times 32-bit words of b, column i + 2j (< 8 * 2^48).
    - Two split passes bring columns 0-15 below 2^21, their carries going
      up into column 16, so T keeps its value; N' times them is < 2^41,
      and one carry pass makes m < R.
    - Columns 0-15 of T + m*p sum to c * R exactly, c < 2^22. Read in
      float64 from the scaled columns, with an error far below 1/2, and
      rounded, it is the carry into column 16.
    One carry pass over columns 16-31 then gives the 16-bit limbs of the
    result, < T / R + p < 2p."""
    np_mat, p_mat, lo_scale = _f64_tables(spec, str(a.device))
    a_lo, bf = a.double(), b.double()
    a_hi = torch.floor(a_lo * 2.0 ** -16)
    a_lo.add_(a_hi, alpha=-65536.0)
    t = torch.zeros(32, a.shape[1], dtype=torch.float64, device=a.device)
    for w in range(NWORDS):
        t[2 * w:2 * w + 16:2].addcmul_(a_lo[w], bf)
        t[2 * w + 1:2 * w + 17:2].addcmul_(a_hi[w], bf)
    lo = t[:16]
    for _ in range(2):
        hi = torch.floor(lo * 2.0 ** -16)
        lo.add_(hi, alpha=-65536.0)
        t[1:17] += hi
    m = _carry16(np_mat @ lo)
    mp = p_mat @ m
    s = t[16:]
    s += mp[1:]
    s[0] += torch.round(mp[0] + lo_scale @ lo)
    s = _carry16(s)
    return _cond_sub_w(spec, s[1::2].mul(65536.0).add_(s[0::2]).long())


def _mont_mul_w(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Words (8, n) x words (8, n) with a*b < p*R (as canonical operands
    have) -> canonical Montgomery product words. A CUDA tensor takes
    `_mont_mul_int64`; a CPU tensor `_mont_mul_block`, in blocks of at most
    `_BLOCK` lanes: 3-8x faster than `_mont_mul_int64` on a CPU core from
    4,128 lanes up, but 2-19x slower on an H100, where each of its many
    small ops is a launch. Both give the same words."""
    if a.is_cuda:
        return _mont_mul_int64(spec, a, b)
    k = max(1, -(-a.shape[1] // _BLOCK))
    return torch.cat([_mont_mul_block(spec, x, y)
                      for x, y in zip(a.tensor_split(k, 1), b.tensor_split(k, 1))], dim=1)


def mont_mul_w(spec: FieldSpec, a, b):
    """`_mont_mul_w` over any batch shape (words in, words out)."""
    shape = a.shape
    return _mont_mul_w(spec, a.reshape(NWORDS, -1), b.reshape(NWORDS, -1)).reshape(shape)


@torch.inference_mode()
def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 (either device): canonical in and out."""
    a, b = torch.broadcast_tensors(a, b)
    return _i32(mont_mul_w(spec, _w(a), _w(b)))


# ---------------------------------------------------------------------------
# K1: Montgomery multiply on the card
# ---------------------------------------------------------------------------

def _unexpand(x: torch.Tensor) -> torch.Tensor:
    """View of `x` with its expanded (stride-0) batch dims cut to size 1."""
    return x[(slice(None),) + tuple(slice(0, 1) if st == 0 else slice(None)
                                    for st in x.stride()[1:])]


def bcast_form(x_shape, shape):
    """How K1 reads a broadcast operand: (period, repeat) such that element j
    of the flattened batch of `shape` is element (j // repeat) % period of
    the flattened batch of `x_shape`; None unless the dims of `x_shape`
    that are not 1 form one contiguous run of the dims of `shape` (limb axes
    first, so both have the same number of dims)."""
    ob, xb = tuple(shape[1:]), tuple(x_shape[1:])
    if len(xb) != len(ob):
        return None
    dims = [i for i, d in enumerate(xb) if d != 1]
    if not dims:
        return 1, 1
    lo, hi = dims[0], dims[-1] + 1
    if xb[lo:hi] != ob[lo:hi]:
        return None
    return int(np.prod(ob[lo:hi])), int(np.prod(ob[hi:]))


def _mont_mul_kernel(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lib = build.lib()
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = _unexpand(a), _unexpand(b)
    if bcast_form(b.shape, shape) is None or (
            a.numel() < b.numel() and bcast_form(a.shape, shape) is not None):
        a, b = b, a                      # the product commutes: b is the broadcast one
    form = bcast_form(b.shape, shape)
    if form is None:
        b = b.expand(shape)
        form = (b[0].numel(), 1)
    a2 = a.expand(shape).reshape(NWORDS, -1).contiguous()
    b2 = b.reshape(NWORDS, -1).contiguous()
    build.require_card("mont_mul", a2, b2, same_width=False)
    out = torch.empty_like(a2)
    n = a2.shape[1]
    if n >= 1 << 31:
        raise ValueError(f"mont_mul: {n} elements, the kernel indexes fewer than 2^31")
    if n:
        build.check(lib.ez_mont_mul(_FIELD_ID[spec.name], a2.data_ptr(), b2.data_ptr(),
                                    out.data_ptr(), n, *form, build.stream_of(a2)), "mont_mul")
        build.LAUNCHES["mont_mul"] += 1
        build.WIDTHS.append(("mont_mul", spec.name, n, n))
    return out.reshape(shape)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p, canonical in and out (K1). On the
    card a broadcast operand is read in place (`bcast_form`), not copied."""
    if a.is_cuda:
        return _mont_mul_kernel(spec, a, b)
    return mont_mul_plain(spec, a, b)


# ---------------------------------------------------------------------------
# public modular ops
# ---------------------------------------------------------------------------

@torch.inference_mode()
def add(spec: FieldSpec, a, b):
    a, b = torch.broadcast_tensors(a, b)
    return _i32(add_w(spec, _w(a), _w(b)))


@torch.inference_mode()
def sub(spec: FieldSpec, a, b):
    a, b = torch.broadcast_tensors(a, b)
    return _i32(sub_w(spec, _w(a), _w(b)))


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def is_zero(a):
    return torch.all(a == 0, dim=0)


def select(mask, a, b):
    """mask: batch-shaped bool. Returns a where mask else b."""
    return torch.where(mask[None], a, b)


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, bcast_const(spec, spec.r2, a.dim() - 1, mont=False,
                                         device=a.device))


def from_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, bcast_const(spec, 1, a.dim() - 1, mont=False,
                                         device=a.device))


# ---------------------------------------------------------------------------
# K1's chain forms: a static power and a sequential prefix product
# ---------------------------------------------------------------------------

@torch.inference_mode()
def pow_static_plain(spec: FieldSpec, a, e: int):
    """Plain PyTorch version of the `mont_pow` form (either device): a^e,
    MSB-first square-and-multiply, the multiply skipped at zero bits."""
    if e == 0:
        return ones_mont(spec, a.shape[1:], a.device).clone()
    x = _w(a)
    acc = x
    for bit in bin(e)[3:]:
        acc = mont_mul_w(spec, acc, acc)
        if bit == "1":
            acc = mont_mul_w(spec, acc, x)
    return _i32(acc)


# bits of `ez_mont_pow`'s sliding window; its table holds the odd powers
# x, x^3, .., x^(2^POW_WINDOW - 1)
POW_WINDOW = 4


@functools.lru_cache(maxsize=None)
def pow_schedule(e: int):
    """The sliding-window schedule of `ez_mont_pow` for a static e >= 1, left
    to right: a window starts at a one bit and takes up to POW_WINDOW bits,
    ending at a one. Returns (first, windows, trailing, products): the table
    index (digit - 1) / 2 of the leading window; per later window the
    squarings before its product (the zeros since the last window and its
    own bits) and its table index; the squarings after the last window; and
    the count of Montgomery products, the table's 2^(POW_WINDOW - 1) among
    them."""
    bits = bin(e)[2:]
    first, windows, zeros, i = None, [], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            zeros, i = zeros + 1, i + 1
            continue
        j = min(i + POW_WINDOW, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        digit = (int(bits[i:j], 2) - 1) // 2
        if first is None:
            first = digit
        else:
            windows.append((zeros + j - i, digit))
        zeros, i = 0, j
    products = (1 << (POW_WINDOW - 1)) + sum(sq for sq, _ in windows) + len(windows) + zeros
    return first, tuple(windows), zeros, products


def _mont_pow_kernel(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e on the card in one launch; 1 <= e < 2^256."""
    if not 1 <= e < 1 << 256:
        raise ValueError(f"mont_pow: exponent out of range [1, 2^256): {e}")
    lib = build.lib()
    a2 = a.reshape(NWORDS, -1).contiguous()
    build.require_card("mont_pow", a2)
    out = torch.empty_like(a2)
    n = a2.shape[1]
    if n:
        first, windows, trailing, products = pow_schedule(e)
        sq = (ctypes.c_uint8 * max(len(windows), 1))(*(w[0] for w in windows))
        dig = (ctypes.c_uint8 * max(len(windows), 1))(*(w[1] for w in windows))
        build.check(lib.ez_mont_pow(_FIELD_ID[spec.name], a2.data_ptr(), out.data_ptr(), n,
                                    ctypes.addressof(sq), ctypes.addressof(dig), len(windows),
                                    first, trailing, build.stream_of(a2)), "mont_pow")
        build.LAUNCHES["mont_pow"] += 1
        build.WIDTHS.append(("mont_pow", spec.name, n, n * products))
    return out.reshape(a.shape)


def pow_static(spec: FieldSpec, a, e: int):
    """a^e for a static exponent (Montgomery form), the `mont_pow` form of
    K1 on the card, `pow_static_plain` on the CPU."""
    if e and a.is_cuda:
        return _mont_pow_kernel(spec, a, e)
    return pow_static_plain(spec, a, e)


def inv(spec: FieldSpec, a):
    """Batched inverse via Fermat: a^(p-2). inv(0) == 0."""
    return pow_static(spec, a, spec.modulus - 2)


@torch.inference_mode()
def seq_scan_mul_plain(spec: FieldSpec, v):
    """Plain PyTorch version of the `mont_scan` form (either device): the
    inclusive prefix product along the last axis, one product per step."""
    w = _w(v)
    acc, outs = w[..., 0], [w[..., 0]]
    for i in range(1, v.shape[-1]):
        acc = mont_mul_w(spec, acc, w[..., i])
        outs.append(acc)
    return _i32(torch.stack(outs, dim=-1))


def _mont_scan_kernel(spec: FieldSpec, v: torch.Tensor) -> torch.Tensor:
    """The prefix product along the last axis on the card, one launch."""
    lib = build.lib()
    steps = v.shape[-1]
    v2 = v.reshape(NWORDS, -1, steps).contiguous()
    build.require_card("mont_scan", v2, ndim=3)
    out = torch.empty_like(v2)
    rows = v2.shape[1]
    if out.numel():
        build.check(lib.ez_mont_scan(_FIELD_ID[spec.name], v2.data_ptr(), out.data_ptr(), rows,
                                     steps, build.stream_of(v2)), "mont_scan")
        build.LAUNCHES["mont_scan"] += 1
        build.WIDTHS.append(("mont_scan", spec.name, rows * steps, rows * (steps - 1)))
    return out.reshape(v.shape)


def seq_scan_mul(spec: FieldSpec, v):
    """Inclusive prefix product along the last axis, one step per element:
    the `mont_scan` form of K1 on the card, `seq_scan_mul_plain` on the CPU."""
    if v.is_cuda:
        return _mont_scan_kernel(spec, v)
    return seq_scan_mul_plain(spec, v)


_SCAN_BLOCK = 32


def _seq_scan(op, init, v):
    """Inclusive scan along the last axis, one step per element."""
    acc, outs = init, []
    for i in range(v.shape[-1]):
        acc = op(acc, v[..., i])
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def _blocked_scan(op, seq, identity_of, v):
    """Blocked inclusive scan along the last axis (as limbs.py:829-883):
    (m, BLOCK) local scans `seq` of BLOCK full-width steps, a recursive scan
    of the m block totals, one combine by `op`."""
    n = v.shape[-1]
    if n <= _SCAN_BLOCK:
        return seq(v)
    m = -(-n // _SCAN_BLOCK)
    if m * _SCAN_BLOCK != n:
        pad = identity_of(v.shape[1:-1] + (m * _SCAN_BLOCK - n,))
        v = torch.cat([v, pad], dim=-1)
    vr = v.reshape(v.shape[:-1] + (m, _SCAN_BLOCK))
    local = _blocked_scan(op, seq, identity_of, vr)
    tot_pref = _blocked_scan(op, seq, identity_of, local[..., -1])
    offs = torch.cat([identity_of(tot_pref.shape[1:-1] + (1,)), tot_pref[..., :-1]], dim=-1)
    combined = op(local, offs[..., None].expand(local.shape))
    return combined.reshape(v.shape[:-1] + (-1,))[..., :n]


def prefix_scan_mul(spec: FieldSpec, v, reverse: bool = False):
    """Inclusive prefix (or suffix) product along the last axis; each block
    of 32 steps is one `seq_scan_mul`."""
    if reverse:
        return prefix_scan_mul(spec, v.flip(-1)).flip(-1)
    return _blocked_scan(lambda x, y: mont_mul(spec, x, y), lambda x: seq_scan_mul(spec, x),
                         lambda shp: ones_mont(spec, shp, v.device), v)


def prefix_scan_add(spec: FieldSpec, v):
    """Inclusive prefix sum along the last axis."""
    op = lambda x, y: add(spec, x, y)                      # noqa: E731
    identity_of = lambda shp: zeros(shp, v.device)         # noqa: E731
    return _blocked_scan(op, lambda x: _seq_scan(op, identity_of(x.shape[1:-1]), x),
                         identity_of, v)


def batch_inv(spec: FieldSpec, a):
    """Montgomery-trick batch inversion along the last axis; zeros invert
    to zero."""
    zero_mask = is_zero(a)
    a_safe = select(zero_mask, ones_mont(spec, a.shape[1:], a.device), a)
    prefix = prefix_scan_mul(spec, a_safe)
    suffix = prefix_scan_mul(spec, a_safe, reverse=True)
    total_inv = inv(spec, prefix[..., -1])
    pad = ones_mont(spec, a.shape[1:-1] + (1,), a.device)
    left = torch.cat([pad, prefix[..., :-1]], dim=-1)
    right = torch.cat([suffix[..., 1:], pad], dim=-1)
    out = mont_mul(spec, mont_mul(spec, left, right), total_inv[..., None])
    return select(zero_mask, torch.zeros_like(out), out)


def powers_dynamic(spec: FieldSpec, base: torch.Tensor, n: int) -> torch.Tensor:
    """[1, b, .., b^(n-1)] as (8, n) from an (8,) Montgomery base on the
    device (prefix product of [1, b, b, ...])."""
    v = torch.cat([ones_mont(spec, (1,), base.device),
                   base[:, None].expand(NWORDS, n - 1)], dim=-1)
    return prefix_scan_mul(spec, v)


def powers(spec: FieldSpec, base_int: int, n: int, device=None) -> torch.Tensor:
    """[base^0, .., base^(n-1)] as (8, n) Montgomery limbs, built on `device`
    by doubling: P[m:2m] = P[:m] * base^m, one `mont_mul` by a host
    constant per doubling (K1 on the card; log2(n) launches). Montgomery
    products are canonical, so these are the words of host bigints and of
    the JAX package's device scan, and at 2^23 no host loop over bigints
    holds the first prove on a key."""
    dev = device_of(device)
    base = base_int % spec.modulus
    out = torch.empty((NWORDS, n), dtype=torch.int32, device=dev)
    out[:, :1] = const(spec, 1, device=dev)[:, None]
    m = 1
    while m < n:
        t = min(m, n - m)
        step = const(spec, pow(base, m, spec.modulus), device=dev)[:, None]
        out[:, m:m + t] = mont_mul(spec, out[:, :t], step)
        m *= 2
    return out
