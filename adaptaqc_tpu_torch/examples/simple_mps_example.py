"""50-qubit MPS example (twin of the JAX package's
examples/simple_mps_example.py): a large circuit where only some qubits
are entangled, compiled with the MPS engine."""

from adaptaqc_tpu_torch import AdaptCompiler, Circuit, MPSBackend
from adaptaqc_tpu_torch.examples._args import device_from_argv


def main(argv=None):
    device = device_from_argv(argv, __doc__.splitlines()[0])
    n = 50
    qc = Circuit(n)
    qc.h(0)
    qc.cx(0, 1)
    qc.h(2)
    qc.cx(2, 3)
    qc.h(range(4, n))

    # Default MPS backend has very minimal truncation.
    adapt_compiler = AdaptCompiler(qc, backend=MPSBackend(device=device))

    result = adapt_compiler.compile()
    print(f"Overlap between circuits is {result.overlap}")
    return result


if __name__ == "__main__":
    main()
