"""AdaptResult: result record of an ADAPT-AQC compilation.

API mirror of adapt-aqc's adaptaqc/compilers/adapt/adapt_result.py:14-71.
"""


class AdaptResult:
    def __init__(self, circuit, overlap, exact_overlap, num_1q_gates,
                 num_2q_gates, cnot_depth_history, global_cost_history,
                 local_cost_history, circuit_history,
                 entanglement_measures_history, e_val_history,
                 qubit_pair_history, method_history, time_taken,
                 cost_evaluations, coupling_map, circuit_qasm):
        """
        :param circuit: Resulting circuit.
        :param overlap: 1 - final_global_cost.
        :param exact_overlap: Only computable with SV backend.
        :param num_1q_gates: Number of rotation gates in circuit.
        :param num_2q_gates: Number of entangling gates in circuit.
        :param cnot_depth_history: 2q depth of the ansatz after each layer.
        :param global_cost_history: Global costs after each layer.
        :param local_cost_history: Local costs after each layer (if used).
        :param circuit_history: QASM snapshots after each layer (if enabled).
        :param entanglement_measures_history: Pairwise entanglements per layer.
        :param e_val_history: sigma_z expectation values per layer.
        :param qubit_pair_history: Qubit pair acted on per layer.
        :param method_history: Pair-selection method used per layer.
        :param time_taken: Total wall-clock of the compilation.
        :param cost_evaluations: Total number of cost evaluations.
        :param coupling_map: Allowed qubit connections.
        :param circuit_qasm: QASM string of the resulting circuit.
        """
        self.circuit = circuit
        self.overlap = overlap
        self.exact_overlap = exact_overlap
        self.num_1q_gates = num_1q_gates
        self.num_2q_gates = num_2q_gates
        self.cnot_depth_history = cnot_depth_history
        self.global_cost_history = global_cost_history
        self.local_cost_history = local_cost_history
        self.circuit_history = circuit_history
        self.entanglement_measures_history = entanglement_measures_history
        self.e_val_history = e_val_history
        self.qubit_pair_history = qubit_pair_history
        self.method_history = method_history
        self.time_taken = time_taken
        self.cost_evaluations = cost_evaluations
        self.coupling_map = coupling_map
        self.circuit_qasm = circuit_qasm

    def __repr__(self):
        return (f"AdaptResult(overlap={self.overlap}, "
                f"num_2q_gates={self.num_2q_gates}, "
                f"layers={len(self.qubit_pair_history)}, "
                f"cost_evaluations={self.cost_evaluations}, "
                f"time_taken={self.time_taken:.2f}s)")
