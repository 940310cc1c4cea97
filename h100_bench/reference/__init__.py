"""The benchmark's plain reference of the codec: a frozen copy of the plain
torch path of `gmix_tpu_torch` at commit 334906b (its spec dataclasses, the
arena layout, the tables, hashes and deterministic transcendentals, the
fresh state, the eager byte step with PPM and the LSTM, the sub-steps'
plain version, the coder), with the CUDA kernels, the CUDA graphs and the
checkpoint code left out.

It imports nothing of `gmix_tpu_torch`, `gmix_tpu` or `jax`: it works the
state and the archive out again from a configuration file's spec, the seed
and the input bytes alone (`codec.encode_prefix`). It runs on the CPU, one
stream a process; the program's archives are held against it byte for byte
(h100_bench/check.py).
"""
