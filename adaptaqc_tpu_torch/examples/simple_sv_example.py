"""Compile a random 4-qubit state (twin of the JAX package's
examples/simple_sv_example.py)."""

import adaptaqc_tpu_torch.utils.circuit_operations as co
from adaptaqc_tpu_torch import AdaptCompiler, SVBackend
from adaptaqc_tpu_torch.examples._args import device_from_argv


def main(argv=None):
    device = device_from_argv(argv, __doc__.splitlines()[0])
    qc = co.create_random_initial_state_circuit(4, seed=0)

    adapt_compiler = AdaptCompiler(qc, backend=SVBackend(device=device))
    result = adapt_compiler.compile()
    approx_circuit = result.circuit
    print(f"Overlap between circuits is {result.overlap}")
    print(f'{"-" * 10}ADAPT-AQC  CIRCUIT{"-" * 10}')
    print(approx_circuit)
    return result


if __name__ == "__main__":
    main()
