"""On-chain layer: execute the rendered Solidity verifier in-repo.

Copy of eigen_zkvm_tpu/onchain/__init__.py.  The reference proves its
verifier.sol works by running `npx hardhat test`
(test/snark_verifier.sh:54-65).  Without solc or node, onchain/solvm.py
executes the contract source directly: a Solidity-subset interpreter with
EVM precompile semantics (ecAdd/ecMul/ecPairing per EIP-196/197, backed by
curves/bn254), so a template or constant-rendering regression makes
verifyTx misbehave and the tests fail.
"""
from .solvm import RevertError, SolContract  # noqa: F401
