"""The five examples of the JAX package's `examples/`, on the port. Each
runs on the card unless given `--device cpu`:

    python3 -m adaptaqc_tpu_torch.examples.readme_example [--device cpu]

and prints "Overlap between circuits is ...". `simple_mps_example` (50
qubits) and `advanced_mps_example` (20 qubits) keep the JAX examples'
widths."""
