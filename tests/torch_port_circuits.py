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
