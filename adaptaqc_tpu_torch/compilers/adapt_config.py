"""AdaptConfig: ADAPT-AQC termination criteria and heuristic knobs.

API mirror of adapt-aqc's adaptaqc/compilers/adapt/adapt_config.py:16-97.
"""

from ..utils import constants as vconstants


class AdaptConfig:
    def __init__(
        self,
        max_layers: int = int(1e5),
        sufficient_cost=vconstants.DEFAULT_SUFFICIENT_COST,
        max_2q_gates=1e4,
        cost_improvement_num_layers=10,
        cost_improvement_tol=1e-2,
        max_layers_to_modify=100,
        method="ISL",
        bad_qubit_pair_memory=10,
        reuse_exponent=0,
        reuse_priority_mode="pair",
        rotosolve_frequency=1,
        rotoselect_tol=1e-5,
        rotosolve_tol=1e-3,
        entanglement_threshold=1e-8,
        local_window_layers=16,
        global_polish_frequency=10,
    ):
        """
        ADAPT-AQC termination criteria.
        :param max_layers: terminate when the ansatz reaches this many layers.
        :param sufficient_cost: terminate when the cost falls below this.
        :param max_2q_gates: terminate when this many 2q gates are used.
        :param cost_improvement_num_layers: window for the stopped-improving test.
        :param cost_improvement_tol: relative-slope tolerance for that test.
        :param max_layers_to_modify: how many trailing layers Rotosolve touches.
        :param method: pair-selection heuristic; one of ISL / expectation /
            basic / random / general_gradient (arXiv:2503.09683) / brickwall.
        :param bad_qubit_pair_memory: ISL bad-pair exclusion window.
        :param reuse_exponent: strength of the not-recently-used priority.
        :param reuse_priority_mode: 'pair' or 'qubit'.
        :param rotosolve_frequency: run Rotosolve after every n layers.
        :param rotoselect_tol / rotosolve_tol: per-cycle improvement tolerances.
        :param entanglement_threshold: ISL treats entanglement below this as 0.
        :param local_window_layers: under optimise_local_cost, the trailing
            window the LOCAL-cost Rotosolve touches. The full-cost probe
            sweep is O(W^2) per cycle (no O(G) environment trick exists for
            per-qubit costs), so the local window must be much smaller than
            max_layers_to_modify. Beyond-reference: the reference's local
            cost runs host probes at the same window and is simply slow.
        :param global_polish_frequency: under optimise_local_cost, run a
            GLOBAL-cost Rotosolve over the full max_layers_to_modify window
            every n layers (the O(G) device sweep). The local cost supplies
            trainable per-layer signal at large n (barren-plateau answer);
            the periodic global polish consolidates toward the actual
            overlap objective. 0 disables.
        """
        self.bad_qubit_pair_memory = bad_qubit_pair_memory
        self.max_layers = max_layers
        self.sufficient_cost = sufficient_cost
        self.max_2q_gates = max_2q_gates
        self.cost_improvement_tol = cost_improvement_tol
        # may be float — callers pass math.inf to disable the plateau check
        # (reference adapt_config.py keeps the raw value)
        self.cost_improvement_num_layers = cost_improvement_num_layers
        self.max_layers_to_modify = max_layers_to_modify
        self.method = method
        self.rotosolve_frequency = rotosolve_frequency
        self.rotoselect_tol = rotoselect_tol
        self.rotosolve_tol = rotosolve_tol
        self.entanglement_threshold = entanglement_threshold
        self.reuse_exponent = reuse_exponent
        self.reuse_priority_mode = reuse_priority_mode.lower()
        self.local_window_layers = local_window_layers
        self.global_polish_frequency = global_polish_frequency

    def __repr__(self):
        rep = f"{self.__class__.__name__}("
        for k, v in self.__dict__.items():
            rep += f"{k}={v!r}, "
        return rep + ")"
