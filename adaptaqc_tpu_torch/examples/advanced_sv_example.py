"""Advanced options example (twin of the JAX package's
examples/advanced_sv_example.py)."""

import numpy as np

from adaptaqc_tpu_torch import AdaptCompiler, AdaptConfig, Circuit, SVBackend
from adaptaqc_tpu_torch.examples._args import device_from_argv


def main(argv=None):
    device = device_from_argv(argv, __doc__.splitlines()[0])
    n = 4
    rng = np.random.default_rng(0)

    # A random circuit starting with a layer of Hadamard gates
    state_prep_circuit = Circuit(n)
    state_prep_circuit.h(range(n))
    qc = state_prep_circuit.copy()
    for _ in range(16):
        a, b = rng.choice(n, 2, replace=False)
        qc.cx(int(a), int(b))
        qc.ry(float(rng.uniform(-np.pi, np.pi)), int(a))

    config = AdaptConfig(
        # Expect slower convergence: decrease the early-exit threshold.
        cost_improvement_tol=1e-5,
        # Run Rotosolve only every 10th layer to reduce computational cost.
        rotosolve_frequency=10,
        # Rotosolve modifies only the last 10 layers.
        max_layers_to_modify=10,
        # Prioritise not reusing the same qubit pairs too often.
        reuse_exponent=1,
        # Stop fine-tuning angles earlier.
        rotosolve_tol=1e-2,
    )

    # We know the solution starts with Hadamards: tell ADAPT-AQC.
    adapt_compiler = AdaptCompiler(
        qc,
        backend=SVBackend(device=device),
        adapt_config=config,
        starting_circuit=state_prep_circuit,
        initial_single_qubit_layer=True,
    )

    result = adapt_compiler.compile()
    approx_circuit = result.circuit
    print(f"Overlap between circuits is {result.overlap}")
    print("Original circuit gates:", qc.count_ops())
    print("Original circuit depth:", qc.depth())
    print("Compiled circuit gates:", approx_circuit.count_ops())
    print("Compiled circuit depth:", approx_circuit.depth())
    return result


if __name__ == "__main__":
    main()
