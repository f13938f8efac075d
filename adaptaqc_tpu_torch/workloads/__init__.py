"""Workload scripts: the paper's two 50-qubit compiles run to their stop
(`random_mps`, `spin_chain`), the timed sweep of `bench.py`
(`bench_sweep`) and a one-call forward step (`entry`). Each runs on the
card unless given `--device cpu` (or `device="cpu"`)."""
