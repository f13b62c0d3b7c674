"""Groth16 JSON and in-memory entry points (BN254).

Port of the JSON half of eigen_zkvm_tpu/groth16/api.py: the same schema
(groth16/src/json_utils.rs of the reference): G1 points as {"x","y"}
decimal (or 0x-hex) strings, G2 points as {"x":[c0,c1], "y":[c0,c1]},
verification key keys vk_alpha_1 / vk_beta_2 / vk_gamma_2 / vk_delta_2 /
IC, proof keys pi_a / pi_b / pi_c, both with protocol="groth16" and the
curve name, so that the two packages write the same bytes.

`save_pk` / `load_pk` keep a proving key in a file of the port's own
(the JAX package pickles its key); `generate_verifier` renders the
Solidity verifier, the JAX package's text byte for byte.

The `*_inplace` entry points take any circuit object with `.constraints`,
`.n_vars`, `.n_publics`, `.w` (the witness) and `.P` (its field, which must
be BN254's Fr).  They run on the current CUDA device unless given
`device="cpu"`.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import groth16 as core
from .groth16 import Proof, ProvingKey, VerifyingKey


def _curve(name: str) -> str:
    if name in ("BN128", "bn128", "BN254", "bn254"):
        return "bn128"
    if name in ("BLS12381", "bls12381", "BLS12-381"):
        raise NotImplementedError("the port's Groth16 is BN254 only")
    raise ValueError(f"unknown curve {name}")


def _s(x: int, to_hex: bool) -> str:
    return format(x, "#066x") if to_hex else str(x)


def _g1_json(pt, to_hex=False):
    if pt is None:
        return {"x": _s(0, to_hex), "y": _s(0, to_hex)}
    return {"x": _s(pt[0], to_hex), "y": _s(pt[1], to_hex)}


def _g2_json(pt, to_hex=False):
    if pt is None:
        return {"x": [_s(0, to_hex)] * 2, "y": [_s(0, to_hex)] * 2}
    return {"x": [_s(pt[0][0], to_hex), _s(pt[0][1], to_hex)],
            "y": [_s(pt[1][0], to_hex), _s(pt[1][1], to_hex)]}


def _num(s: str) -> int:
    return int(s, 16) if s.startswith("0x") or s.startswith("0X") else int(s)


def _g1_parse(d):
    x, y = _num(d["x"]), _num(d["y"])
    return None if x == y == 0 else (x, y)


def _g2_parse(d):
    x = (_num(d["x"][0]), _num(d["x"][1]))
    y = (_num(d["y"][0]), _num(d["y"][1]))
    return None if x == (0, 0) and y == (0, 0) else (x, y)


def vk_to_json(vk: VerifyingKey, to_hex=False) -> str:
    return json.dumps({
        "protocol": "groth16",
        "curve": vk.curve_name,
        "vk_alpha_1": _g1_json(vk.alpha1, to_hex),
        "vk_beta_2": _g2_json(vk.beta2, to_hex),
        "vk_gamma_2": _g2_json(vk.gamma2, to_hex),
        "vk_delta_2": _g2_json(vk.delta2, to_hex),
        "IC": [_g1_json(p, to_hex) for p in vk.ic],
    }, indent=1)


def vk_from_json(s: str) -> VerifyingKey:
    d = json.loads(s)
    return VerifyingKey(
        curve_name=d.get("curve", "bn128"),
        alpha1=_g1_parse(d["vk_alpha_1"]),
        beta2=_g2_parse(d["vk_beta_2"]),
        gamma2=_g2_parse(d["vk_gamma_2"]),
        delta2=_g2_parse(d["vk_delta_2"]),
        ic=[_g1_parse(p) for p in d["IC"]])


def proof_to_json(proof: Proof, curve_name: str, to_hex=False) -> str:
    return json.dumps({
        "pi_a": _g1_json(proof.a, to_hex),
        "pi_b": _g2_json(proof.b, to_hex),
        "pi_c": _g1_json(proof.c, to_hex),
        "protocol": "groth16",
        "curve": curve_name,
    }, indent=1)


def proof_from_json(s: str) -> Proof:
    d = json.loads(s)
    return Proof(a=_g1_parse(d["pi_a"]), b=_g2_parse(d["pi_b"]),
                 c=_g1_parse(d["pi_c"]))


def publics_to_json(publics) -> str:
    return json.dumps([str(int(x)) for x in publics])


def publics_from_json(s: str) -> list[int]:
    return [_num(x) for x in json.loads(s)]


# ---- the proving-key file ----
# One .npz (numpy's uncompressed zip of arrays, read without pickle): the
# version, a JSON header with the sizes and the head points as decimal
# strings, and each query's [n, 2, 4] (G1) or [n, 2, 2, 4] (G2) tensor of
# affine Montgomery words.  The JAX package's CLI pickles its own
# ProvingKey, which only that package can load.

PK_VERSION = 1
_PK_QUERIES = ("a_query", "b1_query", "b2_query", "l_query", "h_query")
_PK_POINTS = ("alpha1", "beta1", "beta2", "delta1", "delta2")


def _point_strs(pt):
    if pt is None:
        return None
    if isinstance(pt, int):
        return str(pt)
    return [_point_strs(c) for c in pt]


def _point_ints(v):
    if v is None:
        return None
    if isinstance(v, str):
        return int(v)
    return tuple(_point_ints(c) for c in v)


def save_pk(path: str, pk: ProvingKey):
    """Write `pk` to `path` (the format above)."""
    header = {"curve": pk.curve_name, "n_public": pk.n_public,
              "n_vars": pk.n_vars, "domain_size": pk.domain_size,
              **{k: _point_strs(getattr(pk, k)) for k in _PK_POINTS}}
    arrays = {k: getattr(pk, k).contiguous().cpu().numpy()
              for k in _PK_QUERIES}
    with open(path, "wb") as f:   # a file object: np.savez adds no suffix
        np.savez(f, version=np.array(PK_VERSION),
                 header=np.array(json.dumps(header)), **arrays)


def load_pk(path: str, device=None) -> ProvingKey:
    """The key `save_pk` wrote, its queries on `device` (None: the current
    CUDA device; raises without one)."""
    dev = core._device(device)
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != PK_VERSION:
            raise ValueError(f"{path}: proving-key file version "
                             f"{int(z['version'])}, not {PK_VERSION}")
        header = json.loads(str(z["header"]))
        queries = {k: torch.from_numpy(z[k]).to(dev) for k in _PK_QUERIES}
    return ProvingKey(
        curve_name=header["curve"], n_public=header["n_public"],
        n_vars=header["n_vars"], domain_size=header["domain_size"],
        **{k: _point_ints(header[k]) for k in _PK_POINTS}, **queries)


# ---- in-memory entry points (reference: api.rs *_inplace variants) ----

def groth16_setup_inplace(curve_name: str, circuit, rng=None, device=None,
                          prof=None) -> tuple[ProvingKey, VerifyingKey]:
    _curve(curve_name)
    if circuit.P != core.R:
        raise ValueError("circuit field != BN254's scalar field")
    return core.setup(circuit.constraints, circuit.n_vars,
                      circuit.n_publics, rng=rng, device=device, prof=prof)


def groth16_prove_inplace(curve_name: str, circuit, pk: ProvingKey,
                          rng=None, prof=None) -> tuple[Proof, list]:
    _curve(curve_name)
    return core.prove(pk, circuit.constraints, circuit.w, rng=rng, prof=prof)


def groth16_verify_inplace(curve_name: str, vk: VerifyingKey, proof: Proof,
                           publics) -> bool:
    _curve(curve_name)
    return core.verify(vk, proof, publics)


# ---- Solidity verifier (reference: api.rs generate_verifier) ----

_PAIRING_LIB = """\
// SPDX-License-Identifier: MIT
pragma solidity ^0.8.0;

library Pairing {
    struct G1Point {
        uint X;
        uint Y;
    }
    // Encoding of field elements is: X[0] * z + X[1]
    struct G2Point {
        uint[2] X;
        uint[2] Y;
    }
    /// @return the generator of G1
    function P1() pure internal returns (G1Point memory) {
        return G1Point(1, 2);
    }
    /// @return the negation of p, i.e. p.addition(p.negate()) should be zero.
    function negate(G1Point memory p) pure internal returns (G1Point memory) {
        uint q = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
        if (p.X == 0 && p.Y == 0)
            return G1Point(0, 0);
        return G1Point(p.X, q - (p.Y % q));
    }
    /// @return r the sum of two points of G1
    function addition(G1Point memory p1, G1Point memory p2) internal view returns (G1Point memory r) {
        uint[4] memory input;
        input[0] = p1.X;
        input[1] = p1.Y;
        input[2] = p2.X;
        input[3] = p2.Y;
        bool success;
        assembly {
            success := staticcall(sub(gas(), 2000), 6, input, 0xc0, r, 0x60)
        }
        require(success);
    }
    /// @return r the product of a point on G1 and a scalar
    function scalar_mul(G1Point memory p, uint s) internal view returns (G1Point memory r) {
        uint[3] memory input;
        input[0] = p.X;
        input[1] = p.Y;
        input[2] = s;
        bool success;
        assembly {
            success := staticcall(sub(gas(), 2000), 7, input, 0x80, r, 0x60)
        }
        require (success);
    }
    /// @return the result of computing the pairing check
    function pairing(G1Point[] memory p1, G2Point[] memory p2) internal view returns (bool) {
        require(p1.length == p2.length);
        uint elements = p1.length;
        uint inputSize = elements * 6;
        uint[] memory input = new uint[](inputSize);
        for (uint i = 0; i < elements; i++)
        {
            input[i * 6 + 0] = p1[i].X;
            input[i * 6 + 1] = p1[i].Y;
            input[i * 6 + 2] = p2[i].X[1];
            input[i * 6 + 3] = p2[i].X[0];
            input[i * 6 + 4] = p2[i].Y[1];
            input[i * 6 + 5] = p2[i].Y[0];
        }
        uint[1] memory out;
        bool success;
        assembly {
            success := staticcall(sub(gas(), 2000), 8, add(input, 0x20), mul(inputSize, 0x20), out, 0x20)
        }
        require(success);
        return out[0] != 0;
    }
    /// Convenience method for a pairing check for four pairs.
    function pairingProd4(
            G1Point memory a1, G2Point memory a2,
            G1Point memory b1, G2Point memory b2,
            G1Point memory c1, G2Point memory c2,
            G1Point memory d1, G2Point memory d2
    ) internal view returns (bool) {
        G1Point[] memory p1 = new G1Point[](4);
        G2Point[] memory p2 = new G2Point[](4);
        p1[0] = a1;
        p1[1] = b1;
        p1[2] = c1;
        p1[3] = d1;
        p2[0] = a2;
        p2[1] = b2;
        p2[2] = c2;
        p2[3] = d2;
        return pairing(p1, p2);
    }
}
"""

_CONTRACT_TEMPLATE = """
contract Verifier {
    using Pairing for *;
    struct VerifyingKey {
        Pairing.G1Point alpha;
        Pairing.G2Point beta;
        Pairing.G2Point gamma;
        Pairing.G2Point delta;
        Pairing.G1Point[] gamma_abc;
    }
    struct Proof {
        Pairing.G1Point a;
        Pairing.G2Point b;
        Pairing.G1Point c;
    }
    function verifyingKey() pure internal returns (VerifyingKey memory vk) {
        vk.alpha = Pairing.G1Point(<%vk_alpha%>);
        vk.beta = Pairing.G2Point(<%vk_beta%>);
        vk.gamma = Pairing.G2Point(<%vk_gamma%>);
        vk.delta = Pairing.G2Point(<%vk_delta%>);
        vk.gamma_abc = new Pairing.G1Point[](<%vk_gamma_abc_length%>);
        <%vk_gamma_abc_pts%>
    }
    function verify(uint[] memory input, Proof memory proof) internal view returns (uint) {
        uint256 snark_scalar_field = 21888242871839275222246405745257275088548364400416034343698204186575808495617;
        VerifyingKey memory vk = verifyingKey();
        require(input.length + 1 == vk.gamma_abc.length);
        // Compute the linear combination vk_x
        Pairing.G1Point memory vk_x = Pairing.G1Point(0, 0);
        for (uint i = 0; i < input.length; i++) {
            require(input[i] < snark_scalar_field);
            vk_x = Pairing.addition(vk_x, Pairing.scalar_mul(vk.gamma_abc[i + 1], input[i]));
        }
        vk_x = Pairing.addition(vk_x, vk.gamma_abc[0]);
        if(!Pairing.pairingProd4(
             proof.a, proof.b,
             Pairing.negate(vk_x), vk.gamma,
             Pairing.negate(proof.c), vk.delta,
             Pairing.negate(vk.alpha), vk.beta)) return 1;
        return 0;
    }
    function verifyTx(
            Proof memory proof<%input_argument%>
        ) public view returns (bool r) {
        uint[] memory inputValues = new uint[](<%vk_input_length%>);
        <%input_loop%>
        if (verify(inputValues, proof) == 0) {
            return true;
        } else {
            return false;
        }
    }
}
"""


def generate_verifier_from_vk(vk: VerifyingKey) -> str:
    def g1s(p):
        return f"uint({p[0]}), uint({p[1]})"

    def g2s(p):
        return (f"[uint({p[0][0]}), uint({p[0][1]})], "
                f"[uint({p[1][0]}), uint({p[1][1]})]")

    text = _CONTRACT_TEMPLATE
    text = text.replace("<%vk_alpha%>", g1s(vk.alpha1))
    text = text.replace("<%vk_beta%>", g2s(vk.beta2))
    text = text.replace("<%vk_gamma%>", g2s(vk.gamma2))
    text = text.replace("<%vk_delta%>", g2s(vk.delta2))
    n = len(vk.ic)
    text = text.replace("<%vk_gamma_abc_length%>", str(n))
    text = text.replace("<%vk_input_length%>", str(n - 1))
    pts = "\n        ".join(
        f"vk.gamma_abc[{i}] = Pairing.G1Point({g1s(p)});"
        for i, p in enumerate(vk.ic))
    text = text.replace("<%vk_gamma_abc_pts%>", pts)
    if n > 1:
        text = text.replace("<%input_loop%>", """
        for(uint i = 0; i < input.length; i++){
            inputValues[i] = input[i];
        }""")
        text = text.replace("<%input_argument%>",
                            f", uint[{n - 1}] memory input")
    else:
        text = text.replace("<%input_loop%>", "")
        text = text.replace("<%input_argument%>", "")
    return _PAIRING_LIB + text


def generate_verifier(vk_file: str, sol_file: str):
    with open(vk_file) as f:
        vk = vk_from_json(f.read())
    with open(sol_file, "w") as f:
        f.write(generate_verifier_from_vk(vk))
