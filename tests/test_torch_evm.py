"""The port's EVM guests (eigen_zkvm_tpu_torch/zkvm/evm.py) against the JAX
package's: the EIP-1559 value-transfer guest and the 256-bit interpreter.

The transfer guest runs on the committed state test
data/guests/transfer_state.json (made-up accounts in the reference's
state-test format, standing in for reth.block.json): `load_state_test`,
`build_image`, `apply_transaction_host`, `unpack_post` and the guest's
status for an OK transfer, a bad nonce, an insufficient balance and a gas
limit under the intrinsic gas equal the JAX package's; the file's
postState is the host model's.  `run_evm256` agrees with
`evm256_reference` and with the JAX package on a few bytecodes.  The
2^11-row chunks, their images and a forged boundary image agree with the
JAX package's.  `prove_state_test(device="cpu")` proves the one-chunk run
(793 cycles fit one 2^11 chunk) with the JAX host engine's proof bytes.

The two-chunk run (rows_budget=512, the one chip_smoke.py's phase 13
proves on the card) is marked slow: about five minutes on one thread on
the CPU, most of it the plain Poseidon of the port's CPU prove.

    JAX_PLATFORMS=cpu python -m pytest -p no:cacheprovider -m slow -s \\
        tests/test_torch_evm.py

prints the JAX host engine's zkin sha256 of the two chunks, the
`GUESTS_SHA256` that chip_smoke.py holds the card's proofs to, and holds
the port's CPU proofs to it.  Every comparison is exact.
"""
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.stark.serializer import stark_proof_to_json as host_json
from eigen_zkvm_tpu.zkvm import evm as j_evm
from eigen_zkvm_tpu.zkvm import rv32_isa as j_isa
from eigen_zkvm_tpu.zkvm import rv32_lib as j_rv32_lib
from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_json
from eigen_zkvm_tpu_torch.zkvm import evm, rv32_isa, rv32_lib
from eigen_zkvm_tpu_torch.zkvm.continuations import ram_digest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = os.path.join(ROOT, "eigen_zkvm_tpu_torch", "data", "guests",
                     "transfer_state.json")
# the one-chunk run's zkin sha256: the JAX package's host engine's proof
# (eigen_zkvm_tpu.zkvm.evm.prove_state_test(STATE, n_bits=11))
ONE_CHUNK_SHA256 = \
    "358180bd87992a53444a0ced3c4e30ffe7c0d567b48c8033df84681632472e2a"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _host_engine(monkeypatch):
    """The JAX package's host engine: it never probes for a TPU."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(proof_json: str) -> str:
    return hashlib.sha256(proof_json.encode()).hexdigest()


def _mutations(pre, env, tx):
    """name: (pre, tx, expected status) for the four outcomes of
    tests/test_evm_vector.py."""
    poor = {a: dict(acc) for a, acc in pre.items()}
    poor[tx["sender"].lower()] = dict(poor[tx["sender"].lower()],
                                      balance=0x1000)
    return {"ok": (pre, tx, evm.STATUS_OK),
            "bad nonce": (pre, dict(tx, nonce="0x7"), evm.STATUS_BAD_NONCE),
            "gas limit": (pre, dict(tx, gasLimit=["0x100"]),
                          evm.STATUS_GAS_LIMIT),
            "insufficient": (poor, tx, evm.STATUS_INSUFFICIENT)}


def _run_transfer(mod, isa, lib, pre, env, tx):
    img, addrs = mod.build_image(pre, env, tx)
    mem = {a: int(v) for a, v in enumerate(img) if v}
    states, final = isa.execute(lib.program_from_asm(mod.TRANSFER_GUEST), 0,
                                mem=mem)
    assert final.halted
    fi = np.zeros(mod.RAM_WORDS, dtype=np.uint64)
    for a, v in mem.items():
        fi[a] = v
    return img, addrs, fi, len(states)


def test_state_test_fixture_is_the_host_models_transition():
    """The committed state test loads as in the JAX package, says it is
    made up, and its postState is apply_transaction_host's."""
    with open(STATE) as f:
        assert "made up" in json.load(f)["_info"]["comment"]
    loaded = evm.load_state_test(STATE)
    assert loaded == j_evm.load_state_test(STATE)
    pre, env, tx, expected = loaded
    post, status, gas = evm.apply_transaction_host(pre, env, tx)
    assert (status, gas) == (evm.STATUS_OK, 21000)
    assert {a: {"nonce": acc["nonce"], "balance": acc["balance"]}
            for a, acc in post.items()} == expected
    assert evm.TRANSFER_GUEST == j_evm.TRANSFER_GUEST
    assert rv32_isa.assemble(evm.TRANSFER_GUEST) == \
        j_isa.assemble(j_evm.TRANSFER_GUEST)


@pytest.mark.parametrize("case", ["ok", "bad nonce", "gas limit",
                                  "insufficient"])
def test_transfer_guest_matches_the_jax_package(case):
    """The image, the guest's run on the port's executor, the unpacked
    post-state, status and gas, and the host model: the JAX package's; a
    rejected transaction leaves the balances untouched."""
    pre, env, tx, expected = evm.load_state_test(STATE)
    pre, tx, want = _mutations(pre, env, tx)[case]
    img, addrs, fi, cycles = _run_transfer(evm, rv32_isa, rv32_lib,
                                           pre, env, tx)
    j_img, j_addrs, j_fi, j_cycles = _run_transfer(j_evm, j_isa, j_rv32_lib,
                                                   pre, env, tx)
    assert np.array_equal(img, j_img) and addrs == j_addrs
    assert np.array_equal(fi, j_fi) and cycles == j_cycles
    post, status, gas = evm.unpack_post(fi, addrs)
    assert (post, status, gas) == j_evm.unpack_post(j_fi, j_addrs)
    host = evm.apply_transaction_host(pre, env, tx)
    assert host == j_evm.apply_transaction_host(pre, env, tx)
    assert status == host[1] == want and gas == host[2]
    for a in addrs:
        assert post[a]["balance"] == host[0][a]["balance"]
        assert post[a]["nonce"] == host[0][a]["nonce"]
    sender = tx["sender"].lower()
    if case == "ok":
        assert cycles == 793
        for a, acc in expected.items():
            assert post[a] == acc
    else:
        assert post[sender] == {"nonce": pre[sender]["nonce"],
                                "balance": pre[sender]["balance"]}


def _push(v: int, n: int = 32) -> bytes:
    return bytes([0x5F + n]) + v.to_bytes(n, "big")


M256 = (1 << 256) - 1
EVM256_CODES = {
    # v = (2^255 + 3) * (2^200 - 1) + 5, wrapped; (v | (NOT v & 0xF0F0))
    # XOR 0xFF
    "arith": (_push(5) + _push((1 << 200) - 1) + _push((1 << 255) + 3)
              + bytes([0x02, 0x01, 0x80, 0x19]) + _push(0xF0F0, 2)
              + bytes([0x16, 0x17]) + _push(0xFF, 1) + bytes([0x18])),
    # SUB below zero, DUP2, SWAP2, LT, GT, EQ, ISZERO
    "compare": (_push(9, 1) + _push(4, 1) + bytes([0x03])
                + _push(7, 1) + bytes([0x81, 0x91, 0x10, 0x81])
                + _push(7, 1) + bytes([0x11, 0x14, 0x15, 0x01])
                + _push(M256) + bytes([0x11])),
    # a JUMPI loop: acc = 0, i = 5; do { acc += i * i; i -= 1 } while (i);
    # PC, POP: acc = 55
    "loop": (_push(0, 1) + _push(5, 1)
             + bytes([0x5B, 0x80, 0x80, 0x02, 0x82, 0x01, 0x91, 0x50])
             + _push(1, 1) + bytes([0x90, 0x03, 0x80]) + _push(4, 1)
             + bytes([0x57, 0x50, 0x58, 0x50])),
    # a JUMP to a byte that is not a JUMPDEST: status 3
    "bad jump": _push(1, 1) + _push(7, 1) + bytes([0x56, 0x00, 0x00]),
    # PUSH32 past the code's end reads zero padding
    "push over the end": _push(3, 1) + bytes([0x7F, 0xAB, 0xCD]),
}


@pytest.mark.parametrize("name", list(EVM256_CODES))
def test_evm256_interpreter_matches_its_model_and_the_jax_package(name):
    code = EVM256_CODES[name]
    assert evm.EVM256_GUEST == j_evm.EVM256_GUEST
    assert np.array_equal(evm.build_evm256_image(code),
                          j_evm.build_evm256_image(code))
    result, status, image, cycles = evm.run_evm256(code)
    j_result, j_status, j_image, j_cycles = j_evm.run_evm256(code)
    assert (result, status, cycles) == (j_result, j_status, j_cycles)
    assert np.array_equal(image, j_image)
    ref = evm.evm256_reference(code)
    assert ref == j_evm.evm256_reference(code)
    assert status == ref[1]
    if status == evm.STATUS_OK and ref[0] is not None:
        assert result == ref[0]
    assert status == (3 if name == "bad jump" else 1)
    v = ((1 << 255) + 3) * ((1 << 200) - 1) + 5 & M256
    want = {"arith": (v | (~v & 0xF0F0)) ^ 0xFF, "compare": 1, "loop": 55,
            "push over the end": 0xABCD << 240}
    if name in want:
        assert result == want[name]


def test_chunks_and_a_forged_boundary_image():
    """The 2^11-row chunks of the transfer (rows_budget=512: two) and their
    images are the JAX package's; a forged sender balance limb in chunk
    1's incoming image breaks the digest chain."""
    pre, env, tx, _ = evm.load_state_test(STATE)
    img, _ = evm.build_image(pre, env, tx)
    prog = rv32_lib.program_from_asm(evm.TRANSFER_GUEST)
    chunks, _ = rv32_lib.rv32_generate_chunks(
        prog, n_bits=11, ram_words=evm.RAM_WORDS, image0=img, rows_budget=512)
    j_chunks, _ = j_rv32_lib.rv32_generate_chunks(
        j_rv32_lib.program_from_asm(j_evm.TRANSFER_GUEST), n_bits=11,
        ram_words=j_evm.RAM_WORDS, image0=img, rows_budget=512)
    assert len(chunks) == len(j_chunks) == 2
    assert [len(s) for s, _ in chunks] == [512, 281 + 1]
    for (_s, a), (_t, b) in zip(chunks, j_chunks):
        assert np.array_equal(a, b)
    d = [ram_digest(c[1]) for c in chunks]
    forged = chunks[1][1].copy()
    forged[34] = int(forged[34]) ^ 0x1   # sender balance limb 0
    out = {f"mem_out{j}": d[1][j] for j in range(4)}
    assert not rv32_lib.check_chain_publics(
        [out, {f"mem_in{j}": ram_digest(forged)[j] for j in range(4)}])
    assert rv32_lib.check_chain_publics(
        [out, {f"mem_in{j}": d[1][j] for j in range(4)}])


def test_entry_points_raise_without_a_card(monkeypatch):
    """device=None is the current CUDA device: without one, prove_state_test
    and prove_evm256 raise before they prove anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: evm.prove_state_test(STATE),
                 lambda: evm.prove_evm256(EVM256_CODES["loop"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_one_chunk_transfer_proves_with_the_host_engines_bytes():
    """prove_state_test(device="cpu") at 2^11 rows, one chunk: the proof's
    zkin is the JAX host engine's (ONE_CHUNK_SHA256), the chain's image
    digests and the post-state hold (the entry point checks them), and
    the JAX package's prove of the same file gives the same bytes."""
    res = evm.prove_state_test(STATE, n_bits=11, device="cpu")
    assert res["n_chunks"] == 1
    assert (res["status"], res["gas_used"]) == (evm.STATUS_OK, 21000)
    assert _sha(stark_proof_to_json(res["proofs"][0])) == ONE_CHUNK_SHA256
    ref = j_evm.prove_state_test(STATE, n_bits=11)
    assert _sha(host_json(ref["proofs"][0])) == ONE_CHUNK_SHA256
    assert res["publics"] == ref["publics"]
    assert res["post"] == ref["post"]


@pytest.mark.slow
def test_host_engine_gives_the_pinned_guests_digests():
    """chip_smoke.GUESTS_SHA256: the JAX host engine's zkin sha256 of the
    transfer's two chunks (n_bits=11, rows_budget=512), printed."""
    smoke = _smoke()
    ref = j_evm.prove_state_test(STATE, n_bits=11, rows_budget=512)
    digests = [_sha(host_json(p)) for p in ref["proofs"]]
    print(f"GUESTS_SHA256: {digests}")
    assert digests == list(smoke.GUESTS_SHA256)


@pytest.mark.slow
def test_two_chunk_transfer_on_the_cpu_matches_the_pinned_digests():
    """The smoke's phase-13 run on the CPU: two chunks, proved, verified
    and chained, each zkin equal to GUESTS_SHA256."""
    smoke = _smoke()
    res = evm.prove_state_test(STATE, n_bits=11, rows_budget=512,
                               device="cpu")
    assert res["n_chunks"] == 2
    assert rv32_lib.check_chain_publics(res["publics"])
    assert [_sha(stark_proof_to_json(p)) for p in res["proofs"]] == \
        list(smoke.GUESTS_SHA256)
