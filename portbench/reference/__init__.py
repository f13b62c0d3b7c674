"""The benchmark's plain reference: an eSTARK verifier written from the
protocol, and the commitments of the benchmark's own inputs.

field.py and tensor_gl.py are Goldilocks (Python ints; int64 tensors and
the coset extension), poseidon.py, merkle.py and transcript.py the hash,
the tree and Fiat-Shamir, air.py the constraint polynomial of a PIL with
its plookup argument, layout.py where a proof keeps each polynomial (the
order of the openings, the intermediate polynomials and the quotient's
degree from the copy of pil-stark's starkinfo compiler under stark/), and
verify.py the verifier.  It imports nothing of the port or of the JAX
package, and reads the program's proofs only to judge them.
"""
