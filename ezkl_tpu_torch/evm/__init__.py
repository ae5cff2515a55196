"""EVM interop: Solidity verifier generation, bytecode emission, the in-repo
EVM and calldata encoding (port of `ezkl_tpu/evm/`; reference L6,
`ezkl/src/eth.rs` + halo2_solidity_verifier). Host code: it reads only the
host fields of a verifying key and needs no device."""

from .solidity import generate_verifier  # noqa: F401
