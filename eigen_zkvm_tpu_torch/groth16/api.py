"""Groth16 JSON and in-memory entry points (BN254).

Port of the JSON half of eigen_zkvm_tpu/groth16/api.py: the same schema
(groth16/src/json_utils.rs of the reference): G1 points as {"x","y"}
decimal (or 0x-hex) strings, G2 points as {"x":[c0,c1], "y":[c0,c1]},
verification key keys vk_alpha_1 / vk_beta_2 / vk_gamma_2 / vk_delta_2 /
IC, proof keys pi_a / pi_b / pi_c, both with protocol="groth16" and the
curve name, so that the two packages write the same bytes.

The `*_inplace` entry points take any circuit object with `.constraints`,
`.n_vars`, `.n_publics`, `.w` (the witness) and `.P` (its field, which must
be BN254's Fr).  They run on the current CUDA device unless given
`device="cpu"`.
"""
from __future__ import annotations

import json

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
