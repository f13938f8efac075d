"""Facade mirroring the reference's `adaptaqc.utils.circuit_operations`
star-import surface (circuit_operations/__init__.py:11-17): one namespace
with basic gate ops, full-circuit surgery, peephole optimisation, running
helpers, circuit division, variational angle IO, and Pauli machinery.
"""

from ..circuits.circuit import (SUPPORTED_1Q_GATES, SUPPORTED_2Q_GATES,    # noqa: F401
                                BASIS_GATES, Circuit, Instruction,
                                create_1q_gate, create_2q_gate,
                                unroll_to_basis_gates)
from ..circuits.operations import *                                        # noqa: F401,F403
from ..circuits.operations import (add_to_circuit, add_gate, add_dressed_cnot,  # noqa: F401
                                   find_angles_in_circuit,
                                   update_angles_in_circuit)
from ..circuits.peephole import (MINIMUM_ROTATION_ANGLE,                   # noqa: F401
                                 find_previous_gate_on_qubit,
                                 remove_unnecessary_1q_gates_from_circuit,
                                 remove_unnecessary_2q_gates_from_circuit,
                                 remove_unnecessary_gates_from_circuit)
from ..circuits.division import (calculate_next_gate_indexes,              # noqa: F401
                                 vertically_divide_circuit)
from ..circuits.running import (counts_data_from_statevector,              # noqa: F401
                                create_noisemodel,
                                run_circuit_with_transpilation,
                                run_circuit_without_transpilation,
                                statevector_from_counts_data,
                                zero_noise_extrapolate)
from ..circuits.pauli_ops import (add_pauli_operators_to_circuit,          # noqa: F401
                                  convert_qubit_op_to_pauli_dict,
                                  expectation_value_of_pauli_operator)
