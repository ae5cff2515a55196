"""File-oriented public API (port of `ezkl_tpu/api.py`, the mirror of
ezkl's Python bindings). Every stage reads/writes artifacts so pipelines are
restartable, and the artifacts are the JAX package's: a file written by
either package loads in the other.

Every function that touches the device takes `device=None`, which means the
card; `device="cpu"` runs the plain versions of the kernels. The graph
layer (settings, compile, the layout of a witness) and aggregation run
on the host. `prove` also takes `checkpoint_dir` (restartable phases,
`plonk/prover.py` `_ProveCheckpoint`; EZKL_TPU_CKPT_DIR sets it too). The
EVM functions (`create_evm_verifier`, `deploy_evm`, `verify_evm`,
`encode_evm_calldata`) are host code (`evm/`): only `create_evm_verifier`
reads the SRS, for its G2 points.

Artifact files:
  settings.json    GraphSettings (run_args + sizing)
  model.compiled   compiled circuit (onnx bytes + settings, JSON/base64)
  witness.json     quantized inputs/outputs (field hex) + rescaled floats
  pk.key / vk.key  stable no-pickle key formats (plonk/serde.py)
  proof.json       proof (points/evals/instances, hex JSON)
  proof_aggr.json  aggregate of N proofs (plonk/aggregate.py)
  kzg{k}.srs       SRS (see plonk/srs.py)
  Verifier.sol     Solidity verifier (+ VerifierVKA.sol when reusable)
  Verifier.bin     its deployable initcode, run on the in-repo EVM
  contract.addr    the deployed verifier's address
  evm_chain.json   the in-repo EVM's state (address -> runtime code)
  calldata.bin     encode_evm_calldata's bytes (proof, then instances)
"""

from __future__ import annotations

import base64
import json
import pathlib

import numpy as np

from .graph.circuit import GraphCircuit, GraphSettings
from .graph.model import Model, forward_float
from .graph.run_args import RunArgs
from .graph import onnx_parser
from .plonk import srs as srsmod
from .plonk import verifier as verifier_mod
from .plonk import serde as serde_mod
from .plonk.prover import Proof

DEFAULT = {
    "model": "network.onnx",
    "settings": "settings.json",
    "compiled": "model.compiled",
    "witness": "witness.json",
    "srs": None,
    "pk": "pk.key",
    "vk": "vk.key",
    "proof": "proof.json",
    "input": "input.json",
}


def _coerce_source(x, scale: int) -> np.ndarray:
    """One input tensor from JSON, polymorphic per element like the
    reference's `FileSourceInner{Float,Bool,Field}`
    (`ezkl/src/graph/input.rs:25-168`):

    * numbers  -> float,
    * booleans -> 1.0 / 0.0,
    * "0x..." hex strings -> BN254 field elements, decoded to their signed
      integer representative and de-scaled by the model input scale so the
      pipeline's quantizer reproduces the same felt exactly (for
      |int| < 2^53; larger pre-quantized felts need Float inputs).
    """
    try:
        return np.asarray(x, dtype=np.float64)  # fast path: all-float
    except (ValueError, TypeError):
        pass
    from .fieldmath.spec import bn254_fr
    p = bn254_fr().modulus
    obj = np.asarray(x, dtype=object)
    flat = obj.reshape(-1)
    out = np.empty(flat.shape, np.float64)
    for i, v in enumerate(flat):
        if isinstance(v, bool):
            out[i] = 1.0 if v else 0.0
        elif isinstance(v, str):
            f = int(v, 16) % p
            if f > p // 2:
                f -= p
            if abs(f) >= 2 ** 53:
                raise ValueError(
                    f"Field input 0x{int(v, 16):x} has signed representative "
                    f"{f}, beyond the 2^53 exact-float range; such "
                    "pre-quantized felts cannot round-trip through the "
                    "quantizer — pass the value as a Float input instead")
            out[i] = f / (2.0 ** scale)
        else:
            out[i] = float(v)
    return out.reshape(obj.shape)


def _load_input(data_path, scales=None) -> list[np.ndarray]:
    d = json.loads(pathlib.Path(data_path).read_text())
    srcs = d["input_data"]
    if scales is None:
        scales = [0] * len(srcs)
    arrays = [_coerce_source(x, s) for x, s in zip(srcs, scales)]
    shapes = d.get("input_shapes")
    if shapes:
        arrays = [a.reshape(s) for a, s in zip(arrays, shapes)]
    return arrays


def gen_settings(model_path, output="settings.json", run_args: RunArgs | None = None,
                 input_path=None) -> GraphSettings:
    ra = run_args or RunArgs()
    gc = GraphCircuit.from_onnx(model_path, ra)
    sample = None
    if input_path:
        sample = _reshape_for(gc, _load_input(input_path, gc.model.input_scales()))
    s = gc.gen_settings(sample)
    pathlib.Path(output).write_text(s.to_json())
    return s


def _reshape_for(gc: GraphCircuit, arrays):
    shapes = gc.model.input_shapes()
    return [np.asarray(a, np.float64).reshape(s) for a, s in zip(arrays, shapes)]


def calibrate_settings(model_path, input_path, settings_path="settings.json",
                       target="resources", scales=None,
                       scale_rebase_multipliers=(1, 2, 10),
                       max_logrows=None, device=None) -> GraphSettings:
    """Grid-search (input_scale x param_scale x rebase multiplier) like the
    reference's calibrate loop (`execute.rs:889-1278`), scoring each cell by
    mean error vs the float forward pass and circuit size, then pick by
    `target`: resources (min k, then error) | accuracy (min error, then k).

    Emits an accuracy tear-sheet (`AccuracyResults` analog,
    `execute.rs:790-884`) into the settings file under "calibration"."""
    base = GraphSettings.from_json(pathlib.Path(settings_path).read_text())
    scales = scales or [4, 5, 6, 7, 8, 10]
    data = json.loads(pathlib.Path(input_path).read_text())
    best = None
    tried = []
    from .utils.progress import progress
    n_cells = sum(len({s, max(2, s - 2)}) for s in scales) \
        * len(scale_rebase_multipliers)
    prog = progress("calibrate", total=n_cells)
    for s in scales:
        for ps in {s, max(2, s - 2)}:
            for rm in scale_rebase_multipliers:
                prog.step(f"scale={s} param={ps} rebase={rm}")
                ra = RunArgs.from_dict({**base.run_args.to_dict(),
                                        "input_scale": s, "param_scale": ps,
                                        "scale_rebase_multiplier": rm})
                span = max(2 ** (s + ps + 3), 2 ** 12)
                ra.lookup_range = (-span, span)
                # coerce OUTSIDE the try: a Field input beyond the exact
                # float range must surface, not be swallowed as a failed
                # grid cell
                gc = GraphCircuit.from_onnx(model_path, ra)
                arrays = _reshape_for(gc, [
                    _coerce_source(x, sc) for x, sc in
                    zip(data["input_data"], gc.model.input_scales())])
                try:
                    st = gc.gen_settings(arrays)
                    if max_logrows is not None and \
                            st.run_args.logrows > max_logrows:
                        continue
                    w = gc.gen_witness(arrays, device=device)
                    got = np.concatenate([
                        np.asarray(o).reshape(-1)
                        for o in w["pretty_elements"]["rescaled_outputs"]])
                    want = np.concatenate([o.reshape(-1) for o in
                                           forward_float(gc.model, arrays)])
                    denom = np.maximum(np.abs(want), 1.0)
                    rel = np.abs(got - want) / denom
                    err = float(np.mean(rel))
                    cell = dict(input_scale=s, param_scale=ps,
                                scale_rebase_multiplier=rm,
                                logrows=st.run_args.logrows,
                                mean_error=err,
                                median_error=float(np.median(rel)),
                                max_error=float(np.max(rel) if rel.size else 0))
                    tried.append(cell)
                    k = st.run_args.logrows
                except (ValueError, OverflowError, NotImplementedError):
                    continue
                score = (k, err) if target == "resources" else (err, k)
                if best is None or score < best[0]:
                    best = (score, st, cell)
    prog.done()
    if best is None:
        raise ValueError("calibration failed for all scale candidates")
    st = best[1]
    out = json.loads(st.to_json())
    out["calibration"] = {"target": target, "chosen": best[2],
                          "grid": tried}
    pathlib.Path(settings_path).write_text(json.dumps(out, indent=1))
    return st


def compile_circuit(model_path, settings_path="settings.json",
                    output="model.compiled"):
    onnx_bytes = pathlib.Path(model_path).read_bytes()
    settings = pathlib.Path(settings_path).read_text()
    blob = json.dumps({
        "onnx_b64": base64.b64encode(onnx_bytes).decode(),
        "settings": json.loads(settings),
    })
    pathlib.Path(output).write_text(blob)
    return output


def load_compiled(compiled_path) -> GraphCircuit:
    d = json.loads(pathlib.Path(compiled_path).read_text())
    settings = GraphSettings.from_json(json.dumps(d["settings"]))
    onnx_bytes = base64.b64decode(d["onnx_b64"])
    model = Model(onnx=onnx_parser.load(onnx_bytes), run_args=settings.run_args)
    return GraphCircuit(model)


def gen_witness(compiled_path, input_path, output="witness.json",
                srs_path=None, device=None) -> dict:
    """The device commits the `kzgcommit` columns, if the model has any."""
    gc = load_compiled(compiled_path)
    arrays = _reshape_for(gc, _load_input(input_path, gc.model.input_scales()))
    srs = None
    if srs_path and pathlib.Path(srs_path).exists():
        srs = srsmod.load(srs_path, device)
    w = gc.gen_witness(arrays, srs=srs, device=device)
    pathlib.Path(output).write_text(json.dumps(w, indent=1))
    return w


def swap_proof_commitments(proof_path="proof.json",
                           witness_path="witness.json") -> bool:
    """Overwrite the proof's advice commitments for kzgcommit-visibility
    columns with the witness's natively-computed KZG commitments
    (reference `swap_proof_commitments`, `src/pfsys/mod.rs:492-554`).

    Returns True if every swapped commitment already matched (an honest
    proof); the swapped proof only verifies when they do — that binding is
    the point of the mechanism (proof splitting / external data commitments).
    """
    proof = json.loads(pathlib.Path(proof_path).read_text())
    wit = json.loads(pathlib.Path(witness_path).read_text())
    pc = wit.get("processed_commitments")
    if not pc:
        raise ValueError("witness has no processed_commitments "
                         "(no kzgcommit-visibility columns)")
    all_matched = True
    for idx, comm in zip(pc["advice_indices"], pc["polycommit"]):
        new = None if comm is None else [hex(int(comm[0], 16)),
                                         hex(int(comm[1], 16))]
        old = proof["advice"][idx]
        norm = None if old is None else [hex(int(old[0], 16)),
                                         hex(int(old[1], 16))]
        if norm != new:
            all_matched = False
        proof["advice"][idx] = new
    pathlib.Path(proof_path).write_text(json.dumps(proof, indent=1))
    return all_matched


def mock(compiled_path, input_path, device=None) -> bool:
    gc = load_compiled(compiled_path)
    arrays = _reshape_for(gc, _load_input(input_path, gc.model.input_scales()))
    fails = gc.mock_prove(arrays, device=device)
    if fails:
        for f in fails[:10]:
            print(f"  {f}")
    return not fails


def gen_srs(srs_path, logrows: int, device=None):
    s = srsmod.gen_srs(logrows, device=device)
    srsmod.save(s, srs_path)
    return srs_path


def get_srs(settings_path="settings.json", logrows=None, srs_path=None,
            device=None):
    if logrows is None:
        st = GraphSettings.from_json(pathlib.Path(settings_path).read_text())
        logrows = st.run_args.logrows
    s = srsmod.get_or_create(logrows, device)
    if srs_path:
        srsmod.save(s, srs_path)
    return s


def setup(compiled_path, input_path, srs_path=None, vk_path="vk.key",
          pk_path="pk.key", device=None):
    """Keygen. Needs representative input for the layout pass (our circuits
    fix the row layout per compiled model, like the reference's compiled
    artifact)."""
    gc = load_compiled(compiled_path)
    arrays = _reshape_for(gc, _load_input(input_path, gc.model.input_scales()))
    s = _srs_for(gc, srs_path, device)
    pk, _ = gc.setup(arrays, s, device=device)
    serde_mod.save_pk(pk, pk_path)
    serde_mod.save_vk(pk.vk, vk_path)
    return pk


def _srs_for(gc: GraphCircuit, srs_path, device):
    if srs_path and pathlib.Path(srs_path).exists():
        s = srsmod.load(srs_path, device)
    else:
        s = srsmod.get_or_create(gc.run_args.logrows, device)
    if s.k > gc.run_args.logrows:
        s = srsmod.truncate(s, gc.run_args.logrows)
    assert s.k == gc.run_args.logrows, f"srs k={s.k} != logrows {gc.run_args.logrows}"
    return s


def _make_transcript(kind):
    """None/'blake2b' -> default; 'evm' -> keccak/big-endian transcript the
    generated Solidity verifier replays."""
    if kind in (None, "blake2b", "poseidon"):
        return None
    if kind == "evm":
        from .plonk.transcript import EvmTranscript
        return EvmTranscript()
    raise ValueError(f"unknown transcript kind {kind!r}")


def prove(compiled_path, input_path, pk_path="pk.key", srs_path=None,
          proof_path="proof.json", transcript=None, seed=None, device=None,
          checkpoint_dir=None):
    """seed: deterministic blinding for byte-reproducible proofs
    (reference det-prove, `src/pfsys/mod.rs:436-439`); also settable via
    EZKL_TPU_DET_SEED. checkpoint_dir: save the prove's two cut points
    there and resume from them (needs a seed; EZKL_TPU_CKPT_DIR sets it
    too, as in the JAX package, whose `prove` has no such argument)."""
    gc = load_compiled(compiled_path)
    arrays = _reshape_for(gc, _load_input(input_path, gc.model.input_scales()))
    s = _srs_for(gc, srs_path, device)
    pk = serde_mod.load_pk(pk_path, device)
    proof, _ = gc.prove(arrays, s, pk=pk, transcript=_make_transcript(transcript),
                        seed=seed, checkpoint_dir=checkpoint_dir)
    pathlib.Path(proof_path).write_text(proof.to_json())
    return proof


def verify(proof_path="proof.json", vk_path="vk.key", srs_path=None,
           settings_path=None, transcript=None, device=None) -> bool:
    """The checks run on the host; the SRS loads onto `device`."""
    vk = serde_mod.load_vk(vk_path)
    if srs_path and pathlib.Path(srs_path).exists():
        s = srsmod.load(srs_path, device)
    else:
        s = srsmod.get_or_create(vk.k, device)
    proof = Proof.from_json(pathlib.Path(proof_path).read_text())
    try:
        return verifier_mod.verify(vk, s.g2, s.s_g2, proof,
                                   transcript=_make_transcript(transcript))
    except (KeyError, IndexError, ValueError, AssertionError):
        return False  # malformed proof = invalid


def aggregate(proof_paths, vk_paths, output="proof_aggr.json",
              srs_path=None) -> dict:
    """Fold N verified proofs into one aggregate artifact whose check is a
    SINGLE pairing (reference `aggregate`, `src/execute.rs`; the native RLC
    fold of plonk/aggregate.py). Host-only: `srs_path` is not read, as in
    the JAX package.

    vk_paths: one per proof, or a single path reused for all proofs."""
    from .plonk import aggregate as aggr_mod
    if isinstance(vk_paths, (str, pathlib.Path)):
        vk_paths = [vk_paths] * len(proof_paths)
    vks = [serde_mod.load_vk(p) for p in vk_paths]
    proofs = [Proof.from_json(pathlib.Path(p).read_text()) for p in proof_paths]
    agg = aggr_mod.aggregate(vks, proofs)
    pathlib.Path(output).write_text(json.dumps(agg))
    return agg


def verify_aggr(aggr_path="proof_aggr.json", vk_paths="vk.key",
                srs_path=None, device=None) -> bool:
    """Verify an aggregate artifact (one pairing for all inner proofs). The
    checks run on the host; the SRS (for its G2 points) loads onto
    `device`."""
    from .plonk import aggregate as aggr_mod
    agg = json.loads(pathlib.Path(aggr_path).read_text())
    n = agg.get("num_proofs", 0)
    if isinstance(vk_paths, (str, pathlib.Path)):
        vk_paths = [vk_paths] * n
    vks = [serde_mod.load_vk(p) for p in vk_paths]
    if not vks:
        return False
    if srs_path and pathlib.Path(srs_path).exists():
        s = srsmod.load(srs_path, device)
    else:
        s = srsmod.get_or_create(vks[0].k, device)
    try:
        return aggr_mod.verify_aggregated(vks, agg, s.g2, s.s_g2)
    except (KeyError, IndexError, ValueError, AssertionError):
        return False


def create_evm_verifier(vk_path="vk.key", srs_path=None,
                        sol_path="Verifier.sol", settings_path=None,
                        reusable: bool = False,
                        n_inst: int | None = None, device=None) -> str:
    """Generate the EVM verifier artifacts for this circuit (reference
    `create-evm-verifier`, `src/execute.rs:1306-1340`). Prove with
    transcript='evm' for proofs the contract accepts.

    Always writes the Solidity source (for users with solc/foundry). When
    the instance count is known (`n_inst`, or a proof.json in the directory
    of `sol_path`, as the JAX package looks for it), ALSO writes
    `<sol_path stem>.bin` — deployable initcode emitted directly by
    `evm.bytecode` — which `deploy_evm`/`verify_evm` run on the in-repo EVM.

    reusable=True additionally writes `<sol_path stem>VKA.sol`: the
    verifier then takes the VKA data-contract address as its first
    argument and extcodecopies the per-circuit constants from it — the
    reference's reusable-verifier + VKA registration pattern
    (`src/commands.rs:148`). The SRS loads onto `device` (only its G2
    points are read)."""
    from .evm import generate_verifier
    vk = serde_mod.load_vk(vk_path)
    if srs_path and pathlib.Path(srs_path).exists():
        s = srsmod.load(srs_path, device)
    else:
        s = srsmod.get_or_create(vk.k, device)
    sol = generate_verifier(vk, s.g2, s.s_g2, reusable=reusable)
    p = pathlib.Path(sol_path)
    p.write_text(sol)
    if reusable:
        from .evm.solidity import generate_vka
        vka_path = p.with_name(p.stem + "VKA.sol")
        vka_path.write_text(generate_vka(vk, s.g2, s.s_g2))
    if n_inst is None:
        proof_near = p.parent / "proof.json"
        if proof_near.exists():
            pf = Proof.from_json(proof_near.read_text())
            n_inst = sum(len(c) for c in pf.instances)
    if n_inst is not None and not reusable:
        from .evm import bytecode as bytecode_mod
        rt = bytecode_mod.emit_verifier(vk, s.g2, s.s_g2, n_inst)
        p.with_suffix(".bin").write_bytes(bytecode_mod.initcode(rt))
    return sol


def deploy_evm(bin_path="Verifier.bin", addr_path="contract.addr",
               chain_path="evm_chain.json", rpc_url=None) -> str:
    """Deploy the bytecode verifier artifact (reference
    `deploy_contract_via_solidity`, src/eth.rs:162).

    The "chain" is the in-repo EVM interpreter (`evm.vm`) persisted to
    `chain_path` — the local-devnet analog of the reference's anvil flow.
    The initcode runs for real: the constructor's RETURN defines the
    deployed runtime code. A live RPC endpoint is refused: the package
    makes no network calls."""
    if rpc_url is not None:
        raise RuntimeError(
            "deploy-evm to a live RPC endpoint needs network access, which "
            "this package does not use. Deploy Verifier.bin with your own "
            "toolchain (reference flow: src/eth.rs:162), or omit rpc_url "
            "to deploy on the in-repo EVM.")
    from .evm import vm as evm_vm
    initcode = pathlib.Path(bin_path).read_bytes()
    E = _load_chain(evm_vm, chain_path)
    addr = E.deploy(initcode)
    _save_chain(E, chain_path)
    pathlib.Path(addr_path).write_text(hex(addr))
    return hex(addr)


def verify_evm(proof_path="proof.json", addr_path="contract.addr",
               chain_path="evm_chain.json", rpc_url=None) -> bool:
    """Verify a proof against the DEPLOYED verifier (reference
    `verify_proof_via_solidity`, src/eth.rs:238): encode calldata, execute
    the contract's code on the EVM, read the returned word. A revert is
    False; a returned word other than 1 raises, as in the JAX package."""
    if rpc_url is not None:
        raise RuntimeError(
            "verify-evm against a live RPC endpoint needs network access, "
            "which this package does not use; omit rpc_url to verify on the "
            "in-repo EVM.")
    from .evm import vm as evm_vm
    calldata = encode_evm_calldata(proof_path, output=None)
    addr = int(pathlib.Path(addr_path).read_text().strip(), 16)
    E = _load_chain(evm_vm, chain_path)
    try:
        out = E.call(addr, calldata)
    except evm_vm.EvmRevert:
        return False
    ok = out == (1).to_bytes(32, "big")
    if not ok:
        raise RuntimeError("proof rejected by on-chain verifier")
    return True


def _load_chain(evm_vm, chain_path):
    E = evm_vm.EVM()
    p = pathlib.Path(chain_path)
    if p.exists():
        state = json.loads(p.read_text())
        for a, code in state.get("code", {}).items():
            E.code[int(a, 16)] = bytes.fromhex(code)
        E._next_addr = int(state.get("next_addr", "0x1000"), 16)
    return E


def _save_chain(E, chain_path):
    state = {
        "code": {hex(a): c.hex() for a, c in E.code.items()},
        "next_addr": hex(E._next_addr),
    }
    pathlib.Path(chain_path).write_text(json.dumps(state))


def split_model(model_path, input_path=None, parts: int = 2,
                output_prefix: str | None = None) -> list:
    """Split a sequential ONNX model into `parts` linked sub-models for
    proof splitting (reference proof_splitting notebook +
    `ProofSplitCommit`, `src/pfsys/mod.rs:317-373`).

    Cuts are placed at node boundaries where exactly ONE tensor crosses,
    closest to an even node split. Prove part i with
    output_visibility=kzgcommit and part i+1 with
    input_visibility=kzgcommit: the boundary commitments are
    byte-identical iff the tensors agree (canonical polycommit rows), so
    verifying all parts + comparing commitments links the whole model —
    this is also the capacity fallback for circuits that outgrow a single
    2^26-row proof (the reference's column-overflow analog; splitting
    also parallelizes proving across devices, and the JAX package folds
    the pieces to one pairing with `aggregate`).

    Returns [(model_path_i, input_names, output_names)] per part and
    writes `<prefix>_part<i>.onnx` (+ `<prefix>_part<i>_input.json` for
    part 0 when input_path is given).
    """
    from .graph import onnx_writer as ow
    from .graph.model import forward_float

    m = Model.load(model_path, RunArgs())
    g = m.onnx.graph
    nodes = g.nodes
    if len(nodes) < parts:
        raise ValueError(f"model has {len(nodes)} nodes; cannot split into "
                         f"{parts} parts")
    init_names = set(g.initializers)
    graph_outputs = [o.name for o in g.outputs]

    # tensors crossing each node boundary b (between nodes[b-1] and nodes[b])
    def crossing(b: int) -> list[str]:
        produced = set()
        for nd in nodes[:b]:
            produced.update(nd.outputs)
        needed = set(graph_outputs)
        for nd in nodes[b:]:
            needed.update(i for i in nd.inputs if i)
        return sorted(produced & needed)

    cuts = []
    lo = 0
    for p in range(1, parts):
        target = round(len(nodes) * p / parts)
        best = None
        for b in range(lo + 1, len(nodes)):
            x = crossing(b)
            if len(x) == 1:
                if best is None or abs(b - target) < abs(best[0] - target):
                    best = (b, x[0])
        if best is None or best[0] <= lo:
            raise ValueError(
                "no single-tensor cut boundary found (non-sequential graph); "
                "split manually or reduce parts")
        cuts.append(best)
        lo = best[0]

    # shapes of the cut tensors from a float forward
    if input_path:
        arrays = _reshape_for(GraphCircuit(m),
                              _load_input(input_path, m.input_scales()))
    else:
        arrays = [np.zeros(s, np.float64) for s in m.input_shapes()]
    _, vals = forward_float(m, arrays, return_all=True)

    prefix = output_prefix or str(pathlib.Path(model_path).with_suffix(""))
    bounds = [0] + [c[0] for c in cuts] + [len(nodes)]
    results = []
    for p in range(parts):
        seg = nodes[bounds[p]:bounds[p + 1]]
        in_names = ([i.name for i in g.inputs] if p == 0 else [cuts[p - 1][1]])
        out_names = ([cuts[p][1]] if p < parts - 1 else graph_outputs)
        inits = {nm: g.initializers[nm] for nd in seg
                 for nm in nd.inputs if nm in init_names}
        w_nodes = [ow.node(nd.op_type, nd.inputs, nd.outputs,
                           name=nd.name, **nd.attrs) for nd in seg]
        in_shapes = {nm: list(np.shape(vals[nm])) for nm in in_names}
        out_shapes = {nm: list(np.shape(vals[nm])) for nm in out_names}
        path = f"{prefix}_part{p}.onnx"
        ow.save(path, w_nodes, in_shapes, out_shapes, inits)
        results.append((path, in_names, out_names))
    if input_path:
        shutil_src = pathlib.Path(input_path)
        pathlib.Path(f"{prefix}_part0_input.json").write_text(
            shutil_src.read_text())
    return results


def gen_random_data(model_path, output="input.json", seed=0):
    gc = GraphCircuit.from_onnx(model_path, RunArgs())
    rng = np.random.default_rng(seed)
    shapes = gc.model.input_shapes()
    data = {
        "input_shapes": [list(s) for s in shapes],
        "input_data": [rng.standard_normal(s).tolist() for s in shapes],
    }
    pathlib.Path(output).write_text(json.dumps(data, indent=1))
    return data


def gen_vk_from_pk(pk_path="pk.key", vk_path="vk.key", device=None):
    """Extract the verifying key from a proving key (reference
    `gen_vk_from_pk_single`, bindings/python.rs:629)."""
    pk = serde_mod.load_pk(pk_path, device)
    serde_mod.save_vk(pk.vk, vk_path)
    return vk_path


def encode_evm_calldata(proof_path="proof.json", output="calldata.bin") -> bytes:
    """Canonical byte encoding of (proof, instances) — the calldata the EVM
    verifier consumes (reference `encode_calldata`, pfsys/mod.rs:70):
    all commitments as 32B||32B big-endian affine pairs in transcript
    order, then evals, then instances."""
    proof = Proof.from_json(pathlib.Path(proof_path).read_text())
    out = bytearray()

    def pt(p):
        if p is None:
            out.extend(b"\x00" * 64)
        else:
            out.extend(int(p[0]).to_bytes(32, "big"))
            out.extend(int(p[1]).to_bytes(32, "big"))

    for group in (proof.advice_commitments, proof.lookup_m_commitments,
                  proof.perm_z_commitments, proof.lookup_phi_commitments,
                  proof.shuffle_z_commitments,
                  [proof.random_commitment], proof.h_commitments):
        for p in group:
            pt(p)
    for label in sorted(proof.evals):
        out.extend(int(proof.evals[label]).to_bytes(32, "big"))
    for p in proof.opening_commitments:
        pt(p)
    for col in proof.instances:
        for v in col:
            out.extend(int(v).to_bytes(32, "big"))
    data = bytes(out)
    if output:
        pathlib.Path(output).write_bytes(data)
    return data


def poseidon_hash(values: list[int]) -> int:
    """Native Poseidon hash of field elements (reference
    `bindings/python.rs:510`)."""
    from .kernels.poseidon import host_hash
    return host_hash([int(v) for v in values])


def table(model_path, run_args: RunArgs | None = None) -> str:
    """Human-readable op summary (reference `Commands::Table`)."""
    m = Model.load(model_path, run_args or RunArgs())
    lines = ["| idx | opkind | inputs | outputs |",
             "|-----|--------|--------|---------|"]
    for i, node in enumerate(m.onnx.graph.nodes):
        lines.append(f"| {i} | {node.op_type} | {node.inputs} | {node.outputs} |")
    return "\n".join(lines)
