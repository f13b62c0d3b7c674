"""Example AIRs with plookup, permutation and connection arguments: copies
of eigen_zkvm_tpu/examples/{plookup,permutation,connection}.py on the
port's PilBuilder, PolsArray and get_ks.

Each module exposes build(n_bits) -> (pil, const_pols, make_trace), where
make_trace(seed) fills the commit PolsArray (mirrors of the reference's JS
trace builders, starkjs/{plookup,permutation,connection}/*.js).
"""
