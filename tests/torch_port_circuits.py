"""The two K=4 circuits of `tests/test_plonk.py`, written against either
package's `cs` module and `Assignment` class, so that the JAX package
(`tools/make_torch_fixtures.py`) and the port (`tests/test_torch_prove.py`)
build the same circuit and witness."""

K = 4


def build_mul_lookup(csmod):
    cs = csmod.ConstraintSystem()
    a = cs.advice_column()
    b = cs.advice_column()
    c = cs.advice_column()
    q_mul = cs.fixed_column()
    table = cs.fixed_column()
    inst = cs.instance_column()
    va, vb, vc = cs.query(a), cs.query(b), cs.query(c)
    cs.create_gate("mul", cs.query(q_mul) * (va * vb - vc))
    cs.add_lookup("a_in_table", [(va,)], (cs.query(table),))
    for col in (a, b, c, inst):
        cs.enable_equality(col)
    return cs, (a, b, c, q_mul, table, inst)


def fill_mul_lookup(cs, cols, Assignment, tamper=False):
    a, b, c, q_mul, table, inst = cols
    asg = Assignment.empty(cs, K)
    avals, bvals, cvals = [2], [3], []
    for i in range(4):
        cvals.append(avals[i] * bvals[i] % 1_000_000_007)
        if i < 3:
            avals.append(cvals[i] % 8)
            bvals.append(1)
    avals = [v % 8 for v in avals]
    cvals = [av * bv for av, bv in zip(avals, bvals)]
    if tamper:
        cvals[2] += 1
    asg.set_ints(a, 0, avals)
    asg.set_ints(b, 0, bvals)
    asg.set_ints(c, 0, cvals)
    asg.set_ints(q_mul, 0, [1] * 4)
    asg.set_ints(table, 0, list(range(8)))
    asg.set_instance(inst, [cvals[3]])
    for i in range(3):
        asg.copy(c, i, a, i + 1)
    asg.copy(c, 3, inst, 0)
    return asg


def build_shuffle(csmod):
    cs = csmod.ConstraintSystem()
    a = cs.advice_column()
    b = cs.advice_column()
    sel = cs.fixed_column()
    va, vb, vs = cs.query(a), cs.query(b), cs.query(sel)
    cs.add_shuffle("b_perm_of_a", (vs * va, vs), (vs * vb, vs))
    return cs, (a, b, sel)


def fill_shuffle(cs, cols, Assignment, tamper=False):
    a, b, sel = cols
    asg = Assignment.empty(cs, K)
    avals = [5, 3, 9, 1, 7, 2]
    bvals = sorted(avals)
    if tamper:
        bvals[2] = 99
    asg.set_ints(a, 0, avals)
    asg.set_ints(b, 0, bvals)
    asg.set_ints(sel, 0, [1] * len(avals))
    return asg


CIRCUITS = {
    "mul_lookup": (build_mul_lookup, fill_mul_lookup),
    "shuffle": (build_shuffle, fill_shuffle),
}


# ---------------------------------------------------------------------------
# Inputs of the fused-MSM fixtures (`fused_*.json`): the point kernels K4-K8,
# `_prefix_points_fused` and `_msm_multi_fused`, made from one numpy seed
# with either package's `hostcurve`, so the JAX run that freezes the outputs
# and the port's tests see the same field values.
# ---------------------------------------------------------------------------

FUSED_SEED = 2
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _obj(rows, shape):
    import numpy as np
    out = np.empty(len(rows), dtype=object)
    out[:] = rows
    return out.reshape(shape)


def _affine(pts, shape):
    """Host affine points -> (x, y) object arrays of `shape`."""
    return tuple(_obj([p[i] for p in pts], shape) for i in range(2))


def _projective(pts, shape, rng):
    """Host points (None = identity (0:1:0)) -> (X, Y, Z) object arrays with
    a random Z per finite point."""
    xs, ys, zs = [], [], []
    for p in pts:
        if p is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            lam = int(rng.integers(2, 1 << 62))
            xs.append(p[0] * lam % FQ_MODULUS), ys.append(p[1] * lam % FQ_MODULUS)
            zs.append(lam)
    return tuple(_obj(v, shape) for v in (xs, ys, zs))


def fused_cases(host):
    """name -> case dict: `kind`, the inputs as object arrays of field
    integers (plain values; callers encode them to Montgomery form), and
    the parameters of the call."""
    import numpy as np
    rng = np.random.default_rng(FUSED_SEED)
    pool = [host.g1_mul(host.G1, int(s)) for s in rng.integers(1, 1 << 30, size=96)]

    def draw(shape, ident=0.0):
        count = int(np.prod(shape))
        pts = [pool[i] for i in rng.integers(0, len(pool), size=count)]
        return [None if rng.random() < ident else p for p in pts]

    m, S = 5, 4
    cases = {}
    sn = rng.integers(0, 2, size=(m, S))
    sn[0, :2] = (0, 1)
    cases["scan_packed"] = dict(kind="scan_packed", xy=_affine(draw((m, S)), (m, S)), sn=sn)
    pts = draw((m, S), ident=0.15)
    pts[3 * S:4 * S] = [None] * S                      # lane 3: identities only
    cases["scan_steps_complete"] = dict(kind="scan_steps", p=_projective(pts, (m, S), rng))
    cases["scan_steps_mixed"] = dict(kind="scan_steps", p=_affine(draw((m, S)), (m, S)))
    G, chunks, blk = 2, 3, 128
    shape = (G, chunks * blk)
    cases["fold_complete"] = dict(kind="fold_lanes", blk=blk,
                                  p=_projective(draw(shape, ident=0.05), shape, rng))
    cases["fold_mixed"] = dict(kind="fold_lanes", blk=blk, p=_affine(draw(shape), shape))
    for c in (3, 9):
        pts = draw((5,))
        pts[2] = None
        cases[f"dbl_pow2_c{c}"] = dict(kind="dbl_pow2", c=c, p=_projective(pts, (5,), rng))
    pts = draw((4, 3))
    pts[4] = None
    cases["horner"] = dict(kind="horner", c=3, p=_projective(pts, (4, 3), rng))
    cases["prefix_points_fused"] = dict(
        kind="prefix_points_fused", p=_projective(draw((2, 64), ident=0.05), (2, 64), rng))
    n, C = 32, 2
    pts = draw((n,))
    scalars = _obj([int.from_bytes(rng.bytes(32), "little") % FR_MODULUS
                    for _ in range(C * n)], (C, n))
    for affine in (True, False):
        p = _affine(pts, (n,)) + (_obj([1] * n, (n,)),) if affine else \
            _projective(pts, (n,), rng)
        cases[f"msm_fused_{'affine' if affine else 'projective'}"] = dict(
            kind="msm_fused", c=4, affine=affine, p=p, scalars=scalars)
    # 24 points padded to 32 as `pad_msm_inputs` pads: (0:1:0) lanes with
    # zero scalars, through the affine pipeline
    real = 24
    padded = [p if i < real else None for i, p in enumerate(pts)]
    cases["msm_fused_padded"] = dict(
        kind="msm_fused", c=4, affine=True,
        p=tuple(_obj([(0, 1, 0)[k] if q is None else (q[0], q[1], 1)[k] for q in padded], (n,))
                for k in range(3)),
        scalars=_obj([v if i % n < real else 0 for i, v in enumerate(scalars.reshape(-1))],
                     (C, n)))
    return cases
