"""CLI (port of `ezkl_tpu/__main__.py`, the mirror of ezkl's
`ezkl <subcommand>` surface, `ezkl/src/commands.rs:390-740`).

    python -m ezkl_tpu_torch gen-settings -M network.onnx
    python -m ezkl_tpu_torch calibrate-settings -M network.onnx -D input.json
    python -m ezkl_tpu_torch compile-circuit -M network.onnx -S settings.json
    python -m ezkl_tpu_torch gen-witness -M model.compiled -D input.json
    python -m ezkl_tpu_torch mock -M model.compiled -D input.json
    python -m ezkl_tpu_torch gen-srs --srs-path kzg14.srs --logrows 14
    python -m ezkl_tpu_torch setup -M model.compiled -D input.json
    python -m ezkl_tpu_torch prove -M model.compiled -D input.json
    python -m ezkl_tpu_torch verify
    python -m ezkl_tpu_torch create-evm-verifier --srs-path kzg14.srs
    python -m ezkl_tpu_torch deploy-evm
    python -m ezkl_tpu_torch verify-evm
    python -m ezkl_tpu_torch encode-evm-calldata
    python -m ezkl_tpu_torch aggregate --proof-paths a.json b.json --vk-paths a.key b.key
    python -m ezkl_tpu_torch verify-aggr --vk-paths a.key b.key
    python -m ezkl_tpu_torch table -M network.onnx
    python -m ezkl_tpu_torch gen-random-data -M network.onnx -D input.json

Every subcommand takes `--device {cuda,cpu}` (default: the card) and
`--log-level`. The EVM subcommands run on the host (the in-repo EVM);
`create-evm-verifier` loads the SRS onto the device. A proof the EVM
verifier accepts comes from `api.prove(..., transcript="evm")`: `prove`
takes no transcript here, as in the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import api
from .graph.run_args import RunArgs


def _add_run_args(p):
    p.add_argument("--input-scale", type=int, default=None)
    p.add_argument("--param-scale", type=int, default=None)
    p.add_argument("--logrows", type=int, default=None)
    p.add_argument("--lookup-range", type=str, default=None,
                   help="min,max (e.g. -32768,32768)")
    p.add_argument("--input-visibility", default=None)
    p.add_argument("--output-visibility", default=None)
    p.add_argument("--param-visibility", default=None)
    p.add_argument("--scale-rebase-multiplier", type=int, default=None)
    p.add_argument("--decomp-base", type=int, default=None)
    p.add_argument("--decomp-legs", type=int, default=None)
    p.add_argument("--ignore-range-check-inputs-outputs", action="store_true",
                   help="skip the Input constrain-on-entry decompose "
                        "(reference flag of the same name)")


def _run_args_from(ns) -> RunArgs:
    ra = RunArgs()
    if ns.input_scale is not None:
        ra.input_scale = ns.input_scale
        ra.param_scale = ns.input_scale
    if ns.param_scale is not None:
        ra.param_scale = ns.param_scale
    if ns.logrows is not None:
        ra.logrows = ns.logrows
    if ns.lookup_range:
        lo, hi = ns.lookup_range.split(",")
        ra.lookup_range = (int(lo), int(hi))
    for name in ("input_visibility", "output_visibility", "param_visibility"):
        v = getattr(ns, name)
        if v is not None:
            setattr(ra, name, v.lower())
    if ns.scale_rebase_multiplier is not None:
        ra.scale_rebase_multiplier = ns.scale_rebase_multiplier
    if ns.decomp_base is not None:
        ra.decomp_base = ns.decomp_base
    if ns.decomp_legs is not None:
        ra.decomp_legs = ns.decomp_legs
    if ns.ignore_range_check_inputs_outputs:
        ra.ignore_range_check_inputs_outputs = True
    return ra.validate()


LOG_LEVELS = ["trace", "debug", "info", "warn", "error", "off"]
LOG_HELP = ("stderr log verbosity (default warn; also EZKL_TPU_LOG) -- the "
            "reference's RUST_LOG analog")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ezkl-tpu-torch",
                                 description="ZKML proving on an NVIDIA GPU "
                                             "(ezkl-compatible pipeline)")
    ap.add_argument("--log-level", default=None, choices=LOG_LEVELS, help=LOG_HELP)
    # the subcommands take it too (SUPPRESS: given before the subcommand,
    # it is not reset by the subcommand's default)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--log-level", default=argparse.SUPPRESS, choices=LOG_LEVELS,
                        help=LOG_HELP)
    common.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the kernels run (default: the card)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def cmd(name, **kw):
        p = sub.add_parser(name, parents=[common], **kw)
        p.add_argument("-M", "--model", default="network.onnx")
        p.add_argument("-D", "--data", default="input.json")
        p.add_argument("-S", "--settings-path", default="settings.json")
        p.add_argument("--compiled-circuit", default="model.compiled")
        p.add_argument("--srs-path", default=None)
        p.add_argument("--vk-path", default="vk.key")
        p.add_argument("--pk-path", default="pk.key")
        p.add_argument("--proof-path", default="proof.json")
        p.add_argument("-O", "--output", default=None)
        return p

    p = cmd("gen-settings")
    _add_run_args(p)
    p = cmd("calibrate-settings")
    p.add_argument("--target", default="resources", choices=["resources", "accuracy"])
    p.add_argument("--scales", default=None, help="comma-separated candidates")
    cmd("compile-circuit")
    cmd("gen-witness")
    cmd("mock")
    p = cmd("gen-srs")
    p.add_argument("--logrows", type=int, required=True)
    p = cmd("get-srs")
    p.add_argument("--logrows", type=int, default=None)
    cmd("setup")
    cmd("prove")
    cmd("verify")
    p = cmd("swap-proof-commitments")
    p.add_argument("--witness-path", default="witness.json")
    p = cmd("gen-vk")
    cmd("encode-evm-calldata")
    p = cmd("create-evm-verifier")
    p.add_argument("--sol-code-path", default="Verifier.sol")
    p.add_argument("--reusable", action="store_true",
                   help="split constants into a VKA data contract "
                        "(<name>VKA.sol); verifier takes the VKA address")
    p = cmd("deploy-evm")
    p.add_argument("--bin-path", default="Verifier.bin")
    p.add_argument("--addr-path", default="contract.addr")
    p.add_argument("--chain-path", default="evm_chain.json")
    p = cmd("verify-evm")
    p.add_argument("--addr-path", default="contract.addr")
    p.add_argument("--chain-path", default="evm_chain.json")
    p = cmd("aggregate")
    p.add_argument("--proof-paths", nargs="+", default=["proof.json"])
    p.add_argument("--vk-paths", nargs="+", default=["vk.key"])
    p = cmd("verify-aggr")
    p.add_argument("--aggr-path", default="proof_aggr.json")
    p.add_argument("--vk-paths", nargs="+", default=["vk.key"])
    p = cmd("table")
    _add_run_args(p)
    p = cmd("gen-random-data")
    p.add_argument("--seed", type=int, default=0)
    p = cmd("split-model")
    p.add_argument("--parts", type=int, default=2)
    p.add_argument("--output-prefix", default=None)

    ns = ap.parse_args(argv)
    if ns.log_level:
        from .utils import log as _log
        _log.set_level(ns.log_level)
    t0 = time.time()
    c = ns.cmd
    dev = ns.device

    if c == "gen-settings":
        s = api.gen_settings(ns.model, ns.settings_path, _run_args_from(ns))
        print(f"settings written to {ns.settings_path} "
              f"(rows={s.num_rows}, k={s.run_args.logrows})")
    elif c == "calibrate-settings":
        scales = [int(x) for x in ns.scales.split(",")] if ns.scales else None
        s = api.calibrate_settings(ns.model, ns.data, ns.settings_path,
                                   target=ns.target, scales=scales, device=dev)
        print(f"calibrated: scale={s.run_args.input_scale}, k={s.run_args.logrows}")
    elif c == "compile-circuit":
        out = api.compile_circuit(ns.model, ns.settings_path,
                                  ns.output or ns.compiled_circuit)
        print(f"compiled -> {out}")
    elif c == "gen-witness":
        w = api.gen_witness(ns.model if ns.model != "network.onnx" else ns.compiled_circuit,
                            ns.data, ns.output or "witness.json",
                            srs_path=ns.srs_path, device=dev)
        print(json.dumps(w["pretty_elements"], indent=1))
    elif c == "mock":
        ok = api.mock(ns.model if ns.model != "network.onnx" else ns.compiled_circuit,
                      ns.data, device=dev)
        print("mock OK" if ok else "mock FAILED")
        sys.exit(0 if ok else 1)
    elif c == "gen-srs":
        api.gen_srs(ns.srs_path or f"kzg{ns.logrows}.srs", ns.logrows, device=dev)
        print(f"srs written ({time.time() - t0:.1f}s)")
    elif c == "get-srs":
        s = api.get_srs(ns.settings_path, ns.logrows, ns.srs_path, device=dev)
        print(f"srs ready (k={s.k})")
    elif c == "setup":
        api.setup(ns.model if ns.model != "network.onnx" else ns.compiled_circuit,
                  ns.data, ns.srs_path, ns.vk_path, ns.pk_path, device=dev)
        print(f"keys written ({time.time() - t0:.1f}s)")
    elif c == "prove":
        api.prove(ns.model if ns.model != "network.onnx" else ns.compiled_circuit,
                  ns.data, ns.pk_path, ns.srs_path, ns.proof_path, device=dev)
        print(f"proof written to {ns.proof_path} ({time.time() - t0:.1f}s)")
    elif c == "verify":
        ok = api.verify(ns.proof_path, ns.vk_path, ns.srs_path, ns.settings_path,
                        device=dev)
        print("verified" if ok else "VERIFICATION FAILED")
        sys.exit(0 if ok else 1)
    elif c == "swap-proof-commitments":
        ok = api.swap_proof_commitments(ns.proof_path, ns.witness_path)
        print("commitments matched" if ok else
              "commitments SWAPPED (proof now binds to witness commitments)")
    elif c == "gen-vk":
        api.gen_vk_from_pk(ns.pk_path, ns.vk_path, device=dev)
        print(f"vk written to {ns.vk_path}")
    elif c == "encode-evm-calldata":
        data = api.encode_evm_calldata(ns.proof_path,
                                       ns.output or "calldata.bin")
        print(f"calldata ({len(data)} bytes) -> {ns.output or 'calldata.bin'}")
    elif c == "create-evm-verifier":
        api.create_evm_verifier(ns.vk_path, ns.srs_path, ns.sol_code_path,
                                ns.settings_path, reusable=ns.reusable, device=dev)
        print(f"Solidity verifier -> {ns.sol_code_path}"
              + (" (+ VKA data contract)" if ns.reusable else ""))
    elif c == "deploy-evm":
        addr = api.deploy_evm(ns.bin_path, ns.addr_path, ns.chain_path)
        print(f"deployed verifier at {addr} (in-repo EVM, "
              f"state -> {ns.chain_path})")
    elif c == "verify-evm":
        ok = api.verify_evm(ns.proof_path, ns.addr_path, ns.chain_path)
        print("proof verified on EVM" if ok else "EVM VERIFICATION FAILED")
        sys.exit(0 if ok else 1)
    elif c == "aggregate":
        vkp = ns.vk_paths if len(ns.vk_paths) > 1 else ns.vk_paths[0]
        agg = api.aggregate(ns.proof_paths, vkp,
                            ns.output or "proof_aggr.json", ns.srs_path)
        print(f"aggregated {agg['num_proofs']} proofs -> "
              f"{ns.output or 'proof_aggr.json'} (one pairing to verify)")
    elif c == "verify-aggr":
        vkp = ns.vk_paths if len(ns.vk_paths) > 1 else ns.vk_paths[0]
        ok = api.verify_aggr(ns.aggr_path, vkp, ns.srs_path, device=dev)
        print("aggregate verified" if ok else "AGGREGATE VERIFICATION FAILED")
        sys.exit(0 if ok else 1)
    elif c == "table":
        print(api.table(ns.model, _run_args_from(ns)))
    elif c == "gen-random-data":
        api.gen_random_data(ns.model, ns.output or ns.data, ns.seed)
        print(f"random data -> {ns.output or ns.data}")
    elif c == "split-model":
        parts = api.split_model(ns.model, ns.data, parts=ns.parts,
                                output_prefix=ns.output_prefix)
        for path, ins, outs in parts:
            print(f"{path}: inputs={ins} outputs={outs}")
        print("prove each part with output/input kzgcommit visibility; "
              "matching boundary commitments link the proofs")


if __name__ == "__main__":
    main()
