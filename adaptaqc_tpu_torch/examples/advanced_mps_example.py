"""Advanced MPS example (twin of the JAX package's
examples/advanced_mps_example.py).

The reference generates an XXZ ground state with TenPy DMRG; TenPy is not
installed, so the target is a first-order-Trotter evolution circuit of the
same XXZ chain (also a bounded-entanglement MPS), compiled with the
general_gradient method of arXiv:2503.09683.
"""

import numpy as np

from adaptaqc_tpu_torch import (AdaptCompiler, AdaptConfig, Circuit,
                                mps_backend_with_args)
from adaptaqc_tpu_torch.examples._args import device_from_argv
from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable


def main(argv=None):
    device = device_from_argv(argv, __doc__.splitlines()[0])
    # Trotterised XXZ chain evolution from the Neel state
    l = 20  # noqa: E741
    dt, steps = 0.2, 3
    qc = Circuit(l)
    qc.x(range(1, l, 2))  # Neel state
    for _ in range(steps):
        for parity in (0, 1):
            for q in range(parity, l - 1, 2):
                # exp(-i dt (XX + YY + 5 ZZ)/4) block, decomposed
                qc.cx(q, q + 1)
                qc.rz(2 * 5.0 * dt / 4, q + 1)
                qc.cx(q, q + 1)
                qc.rx(np.pi / 2, q)
                qc.rx(np.pi / 2, q + 1)
                qc.cx(q, q + 1)
                qc.rz(2 * dt / 4, q + 1)
                qc.cx(q, q + 1)
                qc.rx(-np.pi / 2, q)
                qc.rx(-np.pi / 2, q + 1)

    # The general_gradient method as laid out in arXiv:2503.09683
    config = AdaptConfig(
        method="general_gradient", cost_improvement_num_layers=1e3,
        rotosolve_frequency=10,
    )

    backend = mps_backend_with_args(mps_truncation_threshold=1e-8,
                                    max_chi=32, device=device)

    adapt_compiler = AdaptCompiler(
        target=qc,
        backend=backend,
        adapt_config=config,
        starting_circuit="tenpy_product_state",  # best chi=1 start
        custom_layer_2q_gate=identity_resolvable(),
    )

    result = adapt_compiler.compile()
    print(f"Overlap between circuits is {result.overlap}")
    print(f"2q gates: {result.num_2q_gates}, "
          f"CNOT depth: {result.cnot_depth_history[-1]}")
    return result


if __name__ == "__main__":
    main()
