"""The port's command line and its files against the JAX package's, on the
CPU: .r1cs and .wtns bytes, the proving-key file, the Solidity verifier's
text (run through both packages' onchain/solvm.py), both CLIs in-process
on the same inputs with the same draws (vk, proof, public, zkin and
joined-zkin JSON and the contract byte for byte), and the example AIRs
with plookup, permutation and connection arguments proved through the
port's CLI and held to chip_smoke.py's host-engine digests.  The port runs
with `--device cpu` (its kernels' plain versions); without it, a command
that works on the device raises when there is no CUDA device.
"""
import hashlib
import importlib.util
import json
import os
import pickle
import random
import secrets

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu import cli as jcli
from eigen_zkvm_tpu.algebraic import r1cs_file as jr1cs
from eigen_zkvm_tpu.algebraic import witness as jwit
from eigen_zkvm_tpu.curves import bn254 as jbn
from eigen_zkvm_tpu.examples import connection as jconnection
from eigen_zkvm_tpu.examples import fibonacci
from eigen_zkvm_tpu.examples import permutation as jpermutation
from eigen_zkvm_tpu.examples import plookup as jplookup
from eigen_zkvm_tpu.groth16 import api as japi
from eigen_zkvm_tpu.onchain import SolContract as JSolContract
from eigen_zkvm_tpu.recursion.circuit import CircuitBuilder
from eigen_zkvm_tpu_torch import bench_chain
from eigen_zkvm_tpu_torch import bench_groth16 as bg
from eigen_zkvm_tpu_torch import cli
from eigen_zkvm_tpu_torch.algebraic import r1cs_file, witness
from eigen_zkvm_tpu_torch.examples import connection, permutation, plookup
from eigen_zkvm_tpu_torch.groth16 import api
from eigen_zkvm_tpu_torch.onchain import SolContract

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GL = 0xFFFFFFFF00000001


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


def _toy_circuit():
    """tests/test_groth16.py::_toy_circuit."""
    b = CircuitBuilder(prime=jbn.R)
    out1 = b.public(35)
    out2 = b.public(12)
    x = b.wire(b.sig(5))
    y = b.wire(b.sig(7))
    b.assert_eq(b.mul(x, y), out1)
    b.assert_eq(x + y, out2)
    assert b.check()
    return b


def _r1cs_fields(circ, mod, **extra):
    return mod.R1CS(prime=circ.P, n_wires=circ.n_vars, n_pub_out=0,
                    n_pub_in=circ.n_publics,
                    n_prv_in=circ.n_vars - circ.n_publics - 1,
                    n_labels=circ.n_vars, constraints=list(circ.constraints),
                    wire_map=list(range(circ.n_vars)), **extra)


def _write_circuit_files(tmp_path, circ):
    """The .r1cs, .wtns and JSON witness of a circuit, and for the JAX CLI
    a pickle of its constraints, sizes and witness."""
    paths = {k: str(tmp_path / f"circuit.{k}")
             for k in ("r1cs", "wtns", "json", "pkl")}
    r1cs_file.save_r1cs(paths["r1cs"], _r1cs_fields(circ, r1cs_file))
    witness.save_witness(paths["wtns"], circ.w, circ.P)
    witness.save_witness(paths["json"], circ.w, circ.P)
    with open(paths["pkl"], "wb") as f:   # what the JAX CLI reads of one
        pickle.dump(bg.Circuit(list(circ.constraints), circ.n_vars,
                               circ.n_publics, list(circ.w)), f)
    return paths


@pytest.mark.parametrize("name", ["toy", "synthetic_61", "custom_gates"])
def test_r1cs_file_bytes_equal_the_jax_package(name):
    circ = bg.synthetic(61, 2, seed=3) if name == "synthetic_61" else \
        _toy_circuit()
    extra = {}
    if name == "custom_gates":
        extra = dict(custom_gates=[("Poseidon", []), ("FFT4", [3, 5, 7])],
                     custom_gates_uses=[(0, [1, 2, 3]),
                                        (1, [4, 5, (1 << 33) + 6])])
    port = _r1cs_fields(circ, r1cs_file, **extra)
    data = r1cs_file.to_bytes(port)
    assert data == jr1cs.to_bytes(_r1cs_fields(circ, jr1cs, **extra))
    back = r1cs_file.from_bytes(data)
    assert back.constraints == [
        tuple({s: c % circ.P for s, c in side.items()} for side in row)
        for row in circ.constraints]
    assert (back.n_wires, back.n_publics, back.prime) == \
        (circ.n_vars, circ.n_publics, circ.P)
    assert (back.custom_gates, back.custom_gates_uses) == \
        (extra.get("custom_gates", []), extra.get("custom_gates_uses", []))
    assert r1cs_file.to_bytes(back) == data
    assert r1cs_file.r1cs_to_circuit_inputs(back) == \
        jr1cs.r1cs_to_circuit_inputs(jr1cs.from_bytes(data))
    with pytest.raises(ValueError, match="magic"):
        r1cs_file.from_bytes(b"wtns" + data[4:])


@pytest.mark.parametrize("prime", [jbn.R, GL])
def test_witness_bytes_equal_the_jax_package(tmp_path, prime):
    rng = random.Random(prime & 0xFFFF)
    values = [rng.randrange(prime) for _ in range(50)] + [0, 1, prime - 1]
    data = witness.witness_to_bytes(values, prime)
    assert data == jwit.witness_to_bytes(values, prime)
    assert witness.witness_from_bytes(data) == values
    for suffix in ("wtns", "json"):
        path = str(tmp_path / f"w.{suffix}")
        witness.save_witness(path, values, prime)
        assert witness.load_witness(path) == jwit.load_witness(path) == values
    with pytest.raises(ValueError, match="magic"):
        witness.witness_from_bytes(b"r1cs" + data[4:])


_TOY: dict = {}


def _toy_run():
    """The port's toy-circuit keys and proof from seeded draws, once."""
    if not _TOY:
        b = _toy_circuit()
        pk, vk = api.groth16_setup_inplace("bn128", b, rng=bg.seeded(11),
                                           device="cpu")
        proof, pubs = api.groth16_prove_inplace("bn128", b, pk,
                                                rng=bg.seeded(12))
        _TOY.update(b=b, pk=pk, vk=vk, proof=proof, pubs=pubs)
    return _TOY


def _proof_arg(proof):
    return {"a": {"X": proof.a[0], "Y": proof.a[1]},
            "b": {"X": list(proof.b[0]), "Y": list(proof.b[1])},
            "c": {"X": proof.c[0], "Y": proof.c[1]}}


def test_solidity_verifier_is_the_jax_text_and_accepts_the_port_proof(
        tmp_path):
    run = _toy_run()
    vk, proof, pubs = run["vk"], run["proof"], run["pubs"]
    sol = api.generate_verifier_from_vk(vk)
    assert sol == japi.generate_verifier_from_vk(
        japi.vk_from_json(api.vk_to_json(vk)))
    vk_path, sol_path = str(tmp_path / "vk.json"), str(tmp_path / "v.sol")
    with open(vk_path, "w") as f:
        f.write(api.vk_to_json(vk, to_hex=True))
    api.generate_verifier(vk_path, sol_path)
    with open(sol_path) as f:
        assert f.read() == sol
    for contract in (SolContract(sol), JSolContract(sol)):   # port, JAX
        assert contract.call("verifyTx", _proof_arg(proof), list(pubs)) == 1
        assert contract.call("verifyTx", _proof_arg(proof), [35, 13]) == 0


def test_proving_key_file_round_trip_proves_the_same_bytes(tmp_path):
    run = _toy_run()
    pk = run["pk"]
    path = str(tmp_path / "pk.bin")
    api.save_pk(path, pk)
    assert os.path.exists(path) and not os.path.exists(path + ".npz")
    back = api.load_pk(path, "cpu")
    for name in ("a_query", "b1_query", "b2_query", "l_query", "h_query"):
        assert torch.equal(getattr(back, name), getattr(pk, name)), name
    assert (back.curve_name, back.n_public, back.n_vars, back.domain_size,
            back.alpha1, back.beta1, back.beta2, back.delta1,
            back.delta2) == (pk.curve_name, pk.n_public, pk.n_vars,
                             pk.domain_size, pk.alpha1, pk.beta1, pk.beta2,
                             pk.delta1, pk.delta2)
    proof, pubs = api.groth16_prove_inplace("bn128", run["b"], back,
                                            rng=bg.seeded(12))
    assert api.proof_to_json(proof, "bn128") == \
        api.proof_to_json(run["proof"], "bn128")
    with np.load(path, allow_pickle=False) as z:   # no pickled object in it
        assert sorted(z.files) == sorted(
            ["version", "header", "a_query", "b1_query", "b2_query",
             "l_query", "h_query"])


def _patch_draws(monkeypatch, seed):
    rng = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rng.randrange(n))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("to_hex", [False, True])
def test_groth16_commands_write_the_jax_cli_bytes(monkeypatch, tmp_path,
                                                  to_hex):
    """groth16_setup, groth16_prove, groth16_verify and generate_verifier
    of both CLIs on the toy circuit, secrets.randbelow one seeded draw in
    both: the JAX CLI reads the circuit's pickle, the port's the .r1cs and
    the witness file made from the same constraints and witness."""
    files = _write_circuit_files(tmp_path, _toy_circuit())
    hexflag = ["--to_hex"] if to_hex else []
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        o = {k: str(d / k) for k in ("pk", "vk.json", "proof.json",
                                      "public.json", "verifier.sol")}
        _patch_draws(monkeypatch, 21)
        if side == "jax":
            jcli.main(["groth16_setup", "--circuit", files["pkl"],
                       "--pk", o["pk"], "--vk", o["vk.json"], *hexflag])
            jcli.main(["groth16_prove", "--circuit", files["pkl"],
                       "--pk", o["pk"], "--proof", o["proof.json"],
                       "--public_input", o["public.json"], *hexflag])
            with pytest.raises(SystemExit) as e:
                jcli.main(["groth16_verify", "--vk", o["vk.json"],
                           "--proof", o["proof.json"],
                           "--public_input", o["public.json"]])
            assert e.value.code == 0
            jcli.main(["generate_verifier", "--vk", o["vk.json"],
                       "--sol", o["verifier.sol"]])
        else:
            wit = files["wtns"] if to_hex else files["json"]
            assert cli.main(["groth16_setup", "--circuit", files["r1cs"],
                             "--pk", o["pk"], "--vk", o["vk.json"],
                             "--device", "cpu", *hexflag]) == 0
            assert cli.main(["groth16_prove", "--circuit", files["r1cs"],
                             "--witness", wit, "--pk", o["pk"],
                             "--proof", o["proof.json"], "--public_input",
                             o["public.json"], "--device", "cpu",
                             *hexflag]) == 0
            assert cli.main(["groth16_verify", "--vk", o["vk.json"],
                             "--proof", o["proof.json"],
                             "--public_input", o["public.json"]]) == 0
            assert cli.main(["generate_verifier", "--vk", o["vk.json"],
                             "--sol", o["verifier.sol"]]) == 0
        out[side] = {k: _read(o[k]) for k in ("vk.json", "proof.json",
                                              "public.json", "verifier.sol")}
    assert out["port"] == out["jax"]
    with open(str(tmp_path / "port" / "public.json"), "w") as f:
        f.write('["35", "13"]')
    assert cli.main(["groth16_verify", "--vk", str(tmp_path / "port" /
                                                    "vk.json"),
                     "--proof", str(tmp_path / "port" / "proof.json"),
                     "--public_input",
                     str(tmp_path / "port" / "public.json")]) == 1


def _write_air_files(d, pil_json, struct_json, cp, cm):
    files = {k: str(d / f"air.{k}") for k in ("pil", "struct", "const", "cm")}
    with open(files["pil"], "w") as f:
        json.dump(pil_json, f)
    with open(files["struct"], "w") as f:
        json.dump(struct_json, f)
    cp.save(files["const"])
    cm.save(files["cm"])
    return files


def _stark_args(files, out):
    return ["-s", files["struct"], "-p", files["pil"], "-c", files["const"],
            "-m", files["cm"], "-o", out]


def test_stark_commands_write_the_jax_cli_bytes(tmp_path):
    """stark_prove on examples/fibonacci through both CLIs (the same files,
    the JAX package's PIL writer), stark_verify on either's zkin, and
    join_zkin of the two."""
    pil, cp, mk = fibonacci.build(5)
    files = _write_air_files(tmp_path, jcli._pil_to_json(pil),
                             bench_chain.chain_struct_json(5, 3), cp, mk())
    j_out, p_out = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jcli.main(["stark_prove", *_stark_args(files, j_out)])
    assert cli.main(["stark_prove", *_stark_args(files, p_out),
                     "--device", "cpu"]) == 0
    assert _read(p_out) == _read(j_out)
    verify = ["stark_verify", "-s", files["struct"], "-p", files["pil"],
              "-c", files["const"], "--device", "cpu", "-f"]
    assert cli.main([*verify, j_out]) == 0
    zkin = json.loads(_read(p_out))
    zkin["publics"][0] = str(int(zkin["publics"][0]) + 1)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump(zkin, f)
    assert cli.main([*verify, bad]) == 1
    joined = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        joined[side] = str(tmp_path / f"joined.{side}.json")
        main(["join_zkin", "--zkin1", j_out, "--zkin2", bad,
              "--zkinout", joined[side]])
    assert _read(joined["port"]) == _read(joined["jax"])


def test_unported_options_and_missing_card_raise(monkeypatch, tmp_path):
    files = _write_circuit_files(tmp_path, _toy_circuit())
    pk, vk = str(tmp_path / "pk"), str(tmp_path / "vk.json")
    with pytest.raises(ValueError, match="bls12381 scalar field"):
        cli.main(["groth16_setup", "--circuit", files["r1cs"], "--pk", pk,
                  "--vk", vk, "--curve_type", "BLS12381", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["groth16_setup", "--circuit", files["r1cs"], "--pk", pk,
                  "--vk", vk])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_pk(pk)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["stark_verify", "-s", "s", "-p", "p", "-c", "c",
                  "-f", "f"])


@pytest.mark.parametrize("name", ["plookup", "permutation", "connection"])
def test_argument_airs_prove_through_the_cli_to_the_host_digests(
        tmp_path, name):
    """The port's copies of the example AIRs build the JAX package's (PIL,
    constants, trace); written with bench_chain.pil_to_json (which keeps
    the plookup and permutation identities) and proved through the port's
    stark_prove, each zkin's sha256 is the host engine's digest that
    chip_smoke.py holds the card's proof to, and stark_verify accepts it."""
    smoke = _smoke()
    nbits = smoke.ARG_NBITS[0]
    port_mod = {"plookup": plookup, "permutation": permutation,
                "connection": connection}[name]
    jax_mod = {"plookup": jplookup, "permutation": jpermutation,
               "connection": jconnection}[name]
    pil, cp, mk = port_mod.build(nbits)
    jpil, jcp, jmk = jax_mod.build(nbits)
    cm = mk()
    assert np.array_equal(cp.buffer, jcp.buffer)
    assert np.array_equal(cm.buffer, jmk().buffer)
    pil_json = bench_chain.pil_to_json(pil)
    assert pil_json == {**jcli._pil_to_json(jpil),
                        "plookupIdentities": pil_json["plookupIdentities"],
                        "permutationIdentities":
                            pil_json["permutationIdentities"]}
    files = smoke.write_arg_air(str(tmp_path), name, nbits)
    out = str(tmp_path / "zkin.json")
    assert cli.main(["stark_prove", *_stark_args(files, out),
                     "--device", "cpu"]) == 0
    digest = hashlib.sha256(_read(out)).hexdigest()
    assert digest == smoke.ARG_SHA256[(name, nbits)]
    assert cli.main(["stark_verify", "-s", files["struct"], "-p",
                     files["pil"], "-c", files["const"], "-f", out,
                     "--device", "cpu"]) == 0
