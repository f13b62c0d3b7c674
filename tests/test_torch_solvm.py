"""The port's Solidity-subset interpreter (eigen_zkvm_tpu_torch/onchain/)
against the JAX package's (eigen_zkvm_tpu/onchain/), on the CPU: one
verifier.sol, the port's generate_verifier_from_vk of a seeded Groth16
setup of tests/test_solvm.py's circuit (built with the port's
CircuitBuilder, proved by the port), run by both interpreters on each of
tests/test_solvm.py's seven cases.  The return values and the reverts
must be the same, and each case's answer the one test_solvm.py expects.
"""
import pytest
import torch

from eigen_zkvm_tpu.onchain import RevertError as JRevertError
from eigen_zkvm_tpu.onchain import SolContract as JSolContract
from eigen_zkvm_tpu_torch import bench_groth16 as bg
from eigen_zkvm_tpu_torch.curves import bn254
from eigen_zkvm_tpu_torch.groth16 import api
from eigen_zkvm_tpu_torch.onchain import RevertError, SolContract
from eigen_zkvm_tpu_torch.recursion.circuit import CircuitBuilder

SIDES = {"port": (SolContract, RevertError),
         "jax": (JSolContract, JRevertError)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deployed():
    """tests/test_solvm.py's circuit through the port: seeded setup and
    prove on the CPU, the verifier rendered, one contract a package."""
    b = CircuitBuilder(prime=bn254.R)
    out1 = b.public(35)
    out2 = b.public(12)
    x = b.wire(b.sig(5))
    y = b.wire(b.sig(7))
    b.assert_eq(b.mul(x, y), out1)
    b.assert_eq(x + y, out2)
    pk, vk = api.groth16_setup_inplace("bn128", b, rng=bg.seeded(21),
                                       device="cpu")
    proof, pubs = api.groth16_prove_inplace("bn128", b, pk,
                                            rng=bg.seeded(22))
    sol = api.generate_verifier_from_vk(vk)
    contracts = {side: cls(sol) for side, (cls, _) in SIDES.items()}
    return dict(contracts=contracts, sol=sol, vk=vk, proof=proof,
                pubs=list(pubs))


def _proof_arg(proof, a=None, c=None):
    return {"a": a or {"X": proof.a[0], "Y": proof.a[1]},
            "b": {"X": list(proof.b[0]), "Y": list(proof.b[1])},
            "c": c or {"X": proof.c[0], "Y": proof.c[1]}}


def _outcome(side, fn):
    """("return", value) or ("revert", message) of fn on one side."""
    try:
        return "return", fn()
    except SIDES[side][1] as e:
        return "revert", str(e)


def _verify_case(d, case):
    """(proof argument, publics, contract text) of a verifyTx case."""
    proof, pubs = d["proof"], d["pubs"]
    if case == "accepts":
        return _proof_arg(proof), pubs, None
    if case == "wrong publics":
        return _proof_arg(proof), [35, 13], None
    if case == "tampered":
        # negated y stays on curve: the pairing check fails, no revert
        return _proof_arg(proof, c={"X": proof.c[0],
                                    "Y": (-proof.c[1]) % bn254.P}), pubs, None
    if case == "malformed point":
        return _proof_arg(proof, a={"X": proof.a[0],
                                    "Y": proof.a[1] ^ 1}), pubs, None
    if case == "oversized input":
        return _proof_arg(proof), [bn254.R, pubs[1]], None
    # constant regression: one rendered vk constant off by one
    vk = d["vk"]
    bad = d["sol"].replace(str(vk.ic[1][0]), str(vk.ic[1][0] + 1), 1)
    assert bad != d["sol"]
    return _proof_arg(proof), pubs, bad


EXPECTED = {"accepts": ("return", 1), "wrong publics": ("return", 0),
            "tampered": ("return", 0), "malformed point": "revert",
            "oversized input": "revert", "constant regression": None}


@pytest.mark.parametrize("case", list(EXPECTED))
def test_verify_tx_gives_the_jax_interpreters_answer(deployed, case):
    arg, pubs, text = _verify_case(deployed, case)
    got = {}
    for side, (cls, _) in SIDES.items():
        contract = deployed["contracts"][side] if text is None else cls(text)
        got[side] = _outcome(side, lambda: contract.call("verifyTx", arg,
                                                         list(pubs)))
    assert got["port"] == got["jax"]
    want = EXPECTED[case]
    if want == "revert":
        assert got["port"][0] == "revert"
    elif want is None:   # test_solvm.py: 0, or a revert off the curve
        assert got["port"] == ("return", 0) or got["port"][0] == "revert"
    else:
        assert got["port"] == want


def test_pairing_lib_primitives(deployed):
    """P1, addition, scalar_mul and negate of the Pairing library: the
    same points from both interpreters, and the curve's."""
    results = {}
    for side in SIDES:
        contract = deployed["contracts"][side]
        lib = contract.units["Pairing"]
        g = contract._call_func(lib, "P1", [])
        two_g = contract._call_func(lib, "addition", [g, g])
        five_g = contract._call_func(lib, "scalar_mul", [g, 5])
        neg = contract._call_func(lib, "negate", [g])
        back = contract._call_func(lib, "addition", [neg, two_g])
        results[side] = [(p["X"], p["Y"]) for p in (g, two_g, five_g, neg,
                                                    back)]
    assert results["port"] == results["jax"]
    g, two_g, five_g, _, back = results["port"]
    gen = bn254.g1_from_affine(bn254.G1_GEN)
    assert g == back == bn254.G1_GEN
    assert two_g == bn254.g1_to_affine(bn254.g1_mul(gen, 2))
    assert five_g == bn254.g1_to_affine(bn254.g1_mul(gen, 5))
