"""Minimal example (twin of the JAX package's examples/readme_example.py):
compile a 3-qubit circuit with the default statevector backend and ISL."""

from adaptaqc_tpu_torch import AdaptCompiler, Circuit, SVBackend
from adaptaqc_tpu_torch.examples._args import device_from_argv


def main(argv=None):
    device = device_from_argv(argv, __doc__.splitlines()[0])

    # Setup the circuit
    qc = Circuit(3)
    qc.rx(1.23, 0)
    qc.cx(0, 1)
    qc.ry(2.5, 1)
    qc.rx(-1.6, 2)
    qc.ccx(2, 1, 0)

    # Compile
    compiler = AdaptCompiler(qc, backend=SVBackend(device=device))
    result = compiler.compile()
    compiled_circuit = result.circuit

    print(f'{"-" * 10} ORIGINAL CIRCUIT {"-" * 10}')
    print(qc)
    print(f'{"-" * 10} RECOMPILED CIRCUIT {"-" * 10}')
    print(compiled_circuit)
    print(f"Overlap between circuits is {result.overlap}")
    return result


if __name__ == "__main__":
    main()
