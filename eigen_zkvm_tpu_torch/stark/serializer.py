"""StarkProof <-> snarkjs-compatible zkin JSON.

Copy of eigen_zkvm_tpu/stark/serializer.py (`stark_proof_to_json`,
`stark_proof_from_json` and their dict forms, `join_zkin`,
`join_zkin_chain`) on the port's
StarkProof and FRIProof.

Schema replicates the reference serializer (starky/src/serializer.rs:138-262):
field elements are decimal strings, GF(p^3) values are 3-string lists, GL
Merkle digests are 4-string lists, and the map carries
rootC?, root1..4, evals, s{i}_root/vals/siblings per FRI step, the five
s0_vals*/s0_siblings* query families, finalPol, publics (+ proverAddr for
big-field transcripts).  The output feeds the generated circom verifier, so
it must match what the reference's recursion circuits expect byte-for-byte.
"""
from __future__ import annotations

import json

import numpy as np

from .fri import FRIProof
from .stark_gen import StarkProof


def _s(x) -> str:
    return str(int(x))


def _digest(d):
    """GL digests are 4-string lists; big-field digests a single string."""
    if isinstance(d, (int, np.integer)):
        return _s(d)
    return [_s(x) for x in d]


def _f3(v) -> list[str]:
    return [_s(v[0]), _s(v[1]), _s(v[2])]


def _vals_row(vals) -> list[str]:
    """Base-field leaf values serialize as dim-1 F3G, i.e. plain strings."""
    return [_s(x) for x in np.asarray(vals).reshape(-1)]


def _siblings(mp) -> list[list[str]]:
    return [_digest(node) for node in mp]


def stark_proof_to_dict(proof: StarkProof, hash_type: str = "GL") -> dict:
    out: dict = {}
    if proof.rootC is not None:
        out["rootC"] = _digest(proof.rootC)
    out["root1"] = _digest(proof.root1)
    out["root2"] = _digest(proof.root2)
    out["root3"] = _digest(proof.root3)
    out["root4"] = _digest(proof.root4)
    out["evals"] = [_f3(e) for e in proof.evals]

    fri = proof.fri_proof
    n_steps = len(fri.queries)
    for i in range(1, n_steps):
        out[f"s{i}_root"] = _digest(fri.queries[i]["root"])
        vals, sibs = [], []
        for q in fri.queries[i]["pol_queries"]:
            v, mp = q[0]
            vals.append(_vals_row(v))
            sibs.append(_siblings(mp))
        out[f"s{i}_vals"] = vals
        out[f"s{i}_siblings"] = sibs

    names = ["1", "2", "3", "4", "C"]
    s0_vals = {n: [] for n in names}
    s0_sibs = {n: [] for n in names}
    for q in fri.queries[0]["pol_queries"]:
        for k, n in enumerate(names):
            v, mp = q[k]
            s0_vals[n].append(_vals_row(v))
            s0_sibs[n].append(_siblings(mp))
    for n in names:
        if s0_vals[n]:
            out[f"s0_vals{n}"] = s0_vals[n]
    for n in names:
        if s0_sibs[n]:
            out[f"s0_siblings{n}"] = s0_sibs[n]

    out["finalPol"] = [_f3(e) for e in fri.last]
    pubs = []
    for i in range(proof.publics.shape[0]):
        dim = proof.public_dims[i] if proof.public_dims else 1
        pubs.append(_s(proof.publics[i, 0]) if dim == 1 else _f3(proof.publics[i]))
    out["publics"] = pubs
    if hash_type in ("BN128", "BLS12381"):
        out["proverAddr"] = proof.prover_addr
    return out


def stark_proof_to_json(proof: StarkProof, hash_type: str = "GL") -> str:
    return json.dumps(stark_proof_to_dict(proof, hash_type), separators=(",", ":"))


def _parse_f3(v) -> np.ndarray:
    out = np.zeros(3, dtype=np.uint64)
    if isinstance(v, list):
        for i, x in enumerate(v):
            out[i] = np.uint64(int(x))
    else:
        out[0] = np.uint64(int(v))
    return out


def _parse_digest(v):
    if isinstance(v, list):
        return np.asarray([np.uint64(int(x)) for x in v], dtype=np.uint64)
    return int(v)  # big-field digest value


def _parse_vals(vals) -> np.ndarray:
    return np.asarray([int(x) for x in vals], dtype=np.uint64)


def _parse_sibs(sibs) -> list:
    # GL: levels of 4 sibling limbs; BN128/BLS12381: levels of 16 Fr values
    return [[int(x) for x in node] if len(node) == 16 else _parse_digest(node)
            for node in sibs]


def stark_proof_from_dict(d: dict) -> StarkProof:
    proof = StarkProof()
    if "rootC" in d:
        proof.rootC = _parse_digest(d["rootC"])
    proof.root1 = _parse_digest(d["root1"])
    proof.root2 = _parse_digest(d["root2"])
    proof.root3 = _parse_digest(d["root3"])
    proof.root4 = _parse_digest(d["root4"])
    proof.evals = np.stack([_parse_f3(e) for e in d["evals"]])

    n_steps = 1
    while f"s{n_steps}_root" in d:
        n_steps += 1
    fri = FRIProof(n_steps)

    names = ["1", "2", "3", "4", "C"]
    n_queries = len(d["s0_vals1"])
    for q in range(n_queries):
        qe = []
        for n in names:
            vals = d.get(f"s0_vals{n}")
            sibs = d.get(f"s0_siblings{n}")
            v = _parse_vals(vals[q]) if vals else np.zeros(0, dtype=np.uint64)
            mp = _parse_sibs(sibs[q]) if sibs else []
            qe.append((v, mp))
        fri.queries[0]["pol_queries"].append(qe)

    for i in range(1, n_steps):
        fri.queries[i]["root"] = _parse_digest(d[f"s{i}_root"])
        for q in range(n_queries):
            fri.queries[i]["pol_queries"].append(
                [(_parse_vals(d[f"s{i}_vals"][q]), _parse_sibs(d[f"s{i}_siblings"][q]))])

    fri.last = np.stack([_parse_f3(e) for e in d["finalPol"]]) \
        if d["finalPol"] else np.zeros((0, 3), dtype=np.uint64)
    proof.fri_proof = fri

    pubs = d.get("publics", [])
    proof.publics = np.zeros((len(pubs), 3), dtype=np.uint64)
    proof.public_dims = []
    for i, p in enumerate(pubs):
        v = _parse_f3(p)
        proof.publics[i] = v
        proof.public_dims.append(3 if isinstance(p, list) else 1)
    proof.prover_addr = d.get("proverAddr", "")
    return proof


def stark_proof_from_json(s: str) -> StarkProof:
    return stark_proof_from_dict(json.loads(s))


def join_zkin(zkin1: dict, zkin2: dict) -> dict:
    """Merge two recursive1 proof inputs into one aggregation input
    (reference starky/src/zkin_join.rs: a_/b_ prefixes, shared publics
    minus the 4 rootC limbs, shared rootC; output keys sorted)."""
    out: dict = {}
    for k in sorted(zkin1):
        v = zkin1[k]
        out[f"a_{k}"] = v
        if k == "publics":
            out["publics"] = v[:-4] if isinstance(v, list) and len(v) >= 4 else v
        if k == "rootC":
            out["rootC"] = v
    for k in sorted(zkin2):
        out[f"b_{k}"] = zkin2[k]
    return {k: out[k] for k in sorted(out)}


def join_zkin_chain(zkin1: dict, zkin2: dict, chain_map) -> dict:
    """join_zkin for CONSECUTIVE continuation chunks: the exposed publics
    are the super-chunk's (in-state from a, out-state from b), per the
    ChainMap the aggregation circuit enforces in-circuit
    (recursion/compressor12.ChainMap)."""
    out = join_zkin(zkin1, zkin2)
    a_p, b_p = zkin1["publics"], zkin2["publics"]
    out["publics"] = [
        (a_p if side == "a" else b_p)[idx] for side, idx in chain_map.expose]
    # the exposed rootC is the LEAF proof's: in the left-fold, side b is
    # always a fresh recursive1 leaf, while side a alternates between leaf
    # and aggregation-circuit proofs (whose own rootC is the agg circuit's
    # const root) — the in-circuit binding pins root_c == b_rootC
    out["rootC"] = zkin2["rootC"]
    return {k: out[k] for k in sorted(out)}
