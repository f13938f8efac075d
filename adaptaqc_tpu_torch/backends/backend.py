"""Backend layer: the AQCBackend contract and the engine adapters.

Counterpart of the JAX package's `backends/backend.py`: SVBackend (the
statevector engine), MPSBackend (the MPS engine), SamplingBackend (shot
estimates drawn from the statevector engine, the "QASM" backend),
CenterMPSBackend (the independent center-gauge MPS engine) and
mps_backend_with_args. A backend holds no simulator of its own to call out
to: it evaluates tapes against a cached engine prefix state, so a cost query
after the prefix is one engine call.

Every engine state lives on the backend's `device`, in its `dtype`
(complex64 by default; complex128 for float64 parity work on the CPU). The
device is the CUDA card unless the caller passes `device="cpu"`; building a
backend touches no device, and without a card the first engine state raises
(there is no fallback to the CPU).
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import torch

from .. import config
from ..circuits.circuit import Circuit
from ..circuits.tape import Tape, compile_tape
from . import center_mps, mps_core, sv_core

logger = logging.getLogger(__name__)

DEFAULT_MAX_CHI = 64
DEFAULT_TRUNCATION_THRESHOLD = 1e-16


class AQCBackend(ABC):
    """Backend contract (aqc_backend.py:14-29)."""

    @abstractmethod
    def evaluate_global_cost(self, compiler):
        ...

    @abstractmethod
    def evaluate_local_cost(self, compiler):
        ...

    @abstractmethod
    def evaluate_circuit(self, compiler):
        ...

    @abstractmethod
    def measure_qubit_expectation_values(self, compiler):
        ...


def softening_alpha(compiler) -> float:
    """The softened global cost's penalty weight, |previous cost -
    sufficient cost| (aer_mps_backend.py:49-70). The cost history exists
    once compile() has started; before it, this is a first evaluation
    (previous cost 1)."""
    history = getattr(compiler, "global_cost_history", [])
    previous_cost = history[-1] if history else 1
    return abs(previous_cost - compiler.adapt_config.sufficient_cost)


class SVBackend(AQCBackend):
    """Statevector cost engine (AerSVBackend analogue): the flat (2**n,)
    state of backends/sv_core.py.

    :param device: torch device of every engine state ("cpu", "cuda", ...).
    :param dtype: complex dtype of the engine (complex64 by default).
    :param mesh: optional (dp, tp) DeviceMesh of parallel/mesh.make_mesh,
        inside ranks started by parallel/mesh.launch. Every engine state is
        then tp-sharded over its amplitude axis and pair batches are
        dp-sharded (parallel/sv_sharded.py); results match the unsharded
        engine (tests/test_torch_mesh.py).
    """

    engine_name = "sv"

    def __init__(self, device="cuda", dtype: torch.dtype = None, mesh=None):
        self.device = torch.device(device)
        self.dtype = dtype or config.DEFAULT_DTYPE
        self.mesh = mesh

    @property
    def _engine(self):
        """sv_core, or under a mesh sv_sharded with the mesh bound (the same
        names and arguments)."""
        if self.mesh is None:
            return sv_core
        from ..parallel import mesh as pmesh
        from ..parallel import sv_sharded
        return pmesh.OnMesh(sv_sharded, self.mesh)

    # ------------------------------------------------------- engine plumbing
    def initial_state(self, circuit: Circuit, n: int):
        """Engine state for the leading state-injection instruction, if
        any, else |0...0>."""
        if circuit.data and circuit.data[0].name == "set_statevector":
            state = sv_core.state_from_vector(circuit.data[0].payload,
                                              self.dtype, self.device)
            if self.mesh is None:
                return state
            from ..parallel import mesh as pmesh
            return pmesh.shard_state(self.mesh, state)
        if circuit.data and circuit.data[0].name == "set_mps":
            raise ValueError("SV backend cannot consume an MPS target")
        return self._engine.zero_state(n, self.dtype, self.device)

    def run_tape(self, state, tape: Tape):
        return self._engine.apply_tape(state, tape.kinds, tape.q0, tape.q1,
                                       tape.angles)

    def run_tape_adjoint(self, state, tape: Tape):
        return self._engine.apply_tape_adjoint(state, tape.kinds, tape.q0,
                                               tape.q1, tape.angles)

    def state_of(self, compiler):
        return compiler._current_state()

    def sweep_engine(self):
        return self._engine.sweep_engine()

    def zero_ref(self, compiler):
        return self._engine.zero_state(compiler.full_circuit.num_qubits,
                                       self.dtype, self.device)

    # ----------------------------------------------------------- cost layer
    def evaluate_global_cost(self, compiler):
        """1 - |<0|psi>|^2 (aer_sv_backend.py:28-30), one device sync;
        softened, less alpha times the Hamming-1 overlap sum (the
        reference raises here; a statevector gives the terms directly, and
        the full-cost sweep optimises them on this engine)."""
        state = self.state_of(compiler)
        if not compiler.soften_global_cost:
            return float(self._engine.global_cost(state))
        g, _, h1 = self._engine.full_cost_terms(state,
                                                self.zero_ref(compiler))
        return float(g) - softening_alpha(compiler) * float(h1)

    def evaluate_local_cost(self, compiler):
        e_vals = self.measure_qubit_expectation_values(compiler)
        return float(0.5 * (1 - np.mean(e_vals)))

    def evaluate_circuit(self, compiler):
        return self.state_of(compiler)

    def measure_qubit_expectation_values(self, compiler):
        """<Z_q> of every qubit (one device sync)."""
        state = self.state_of(compiler)
        return self._engine.z_expectations(
            state, compiler.full_circuit.num_qubits).cpu().numpy().tolist()

    # -------------------------------------------------------- analysis layer
    def all_pair_rdms(self, state, pairs):
        """Host (4, 4) RDMs of the pairs, computed on the device and read
        back together (one sync); under a mesh the pairs are dp-sharded."""
        return list(self._engine.all_pair_rdms(state, pairs).cpu().numpy())

    def two_qubit_rdm(self, circuit_or_compiler, q1, q2, state=None):
        if state is None:
            state = self.state_of(circuit_or_compiler)
        lo, hi = min(q1, q2), max(q1, q2)
        return self._engine.rdm2(state, lo, hi).cpu().numpy()


class MPSBackend(AQCBackend):
    """MPS cost engine (AerMPSBackend analogue).

    :param truncation_threshold: singular values at or below this are
        discarded (matrix_product_state_truncation_threshold).
    :param max_chi: padded bond dimension the engine truncates to (the Aer
        default is unbounded; a fixed cap keeps tensor shapes fixed;
        DEFAULT_MAX_CHI when unset). The discarded weight is tracked in
        MPS.trunc, so a binding cap is never silent.
    :param mps_log_data: log the accumulated discarded weight after every
        tape execution (one device sync each).
    :param device: torch device of every engine state ("cpu", "cuda", ...).
    :param dtype: complex dtype of the engine (complex64 by default).
    :param mesh: optional (dp, tp) DeviceMesh of parallel/mesh.make_mesh,
        inside ranks started by parallel/mesh.launch: every engine MPS is
        then tp-sharded over its bond (chi) axis, the sweeps' environment
        chains and observables contract over the shards with collectives,
        and each two-qubit apply solves its replicated Gram with K2-K4 on
        every rank (parallel/mps_sharded.py). The env-chain kernel and the
        incremental environments do not run under a mesh, as in the JAX
        package. Results match the unsharded engine.
    """

    engine_name = "mps"

    def __init__(self, truncation_threshold: float = DEFAULT_TRUNCATION_THRESHOLD,
                 max_chi: Optional[int] = None, mps_log_data: bool = False,
                 device="cuda", dtype: torch.dtype = None, mesh=None):
        self.truncation_threshold = float(truncation_threshold)
        self.max_chi = max_chi
        self.mps_log_data = mps_log_data
        self.device = torch.device(device)
        self.dtype = dtype or config.DEFAULT_DTYPE
        self.mesh = mesh

    @property
    def _engine(self):
        """mps_core, or under a mesh mps_sharded with the mesh bound (the
        same names and arguments)."""
        if self.mesh is None:
            return mps_core
        from ..parallel import mesh as pmesh
        from ..parallel import mps_sharded
        return pmesh.OnMesh(mps_sharded, self.mesh)

    def _shard(self, state):
        """An engine MPS as the backend holds it: chi-sharded under a
        mesh."""
        if self.mesh is None:
            return state
        from ..parallel import mesh as pmesh
        return pmesh.shard_mps(self.mesh, state)

    @staticmethod
    def truncated_weight(state) -> float:
        """Total relative Schmidt weight discarded by the 2q applies that
        produced `state` (one device sync)."""
        from ..parallel.mesh import local
        return float(local(state.trunc))

    def chi_for(self, n: int) -> int:
        cap = self.max_chi or DEFAULT_MAX_CHI
        return int(min(cap, max(2, 2 ** ((n + 1) // 2))))

    def initial_state(self, circuit: Circuit, n: int):
        chi = self.chi_for(n)
        kw = dict(dtype=self.dtype, device=self.device)
        if circuit.data and circuit.data[0].name == "set_mps":
            payload = circuit.data[0].payload
            if isinstance(payload, mps_core.MPS):
                if payload.chi != chi:
                    raise ValueError("cached MPS chi mismatch")
                return self._shard(payload)
            return self._shard(mps_core.from_qiskit_mps(payload, chi, **kw))
        if circuit.data and circuit.data[0].name == "set_statevector":
            return self._shard(mps_core.from_dense(circuit.data[0].payload,
                                                   chi, **kw))
        return self._zero(n, chi)

    def _zero(self, n: int, chi: int):
        """|0...0> as the backend holds it; under a mesh each rank makes
        only its shard."""
        kw = dict(dtype=self.dtype, device=self.device)
        if self.mesh is None:
            return mps_core.zero_mps(n, chi, **kw)
        from ..parallel import mps_sharded
        return mps_sharded.zero_mps(self.mesh, n, chi, **kw)

    def run_tape(self, state, tape: Tape):
        out = self._engine.apply_tape(state, tape.kinds, tape.q0, tape.q1,
                                      tape.angles, self.truncation_threshold)
        if self.mps_log_data:
            logger.info("mps_log_data: accumulated discarded Schmidt weight "
                        f"= {self.truncated_weight(out):.3e} "
                        f"(chi={out.chi})")
        return out

    def run_tape_adjoint(self, state, tape: Tape):
        return self._engine.apply_tape_adjoint(state, tape.kinds, tape.q0,
                                               tape.q1, tape.angles,
                                               self.truncation_threshold)

    def state_of(self, compiler):
        return compiler._current_state()

    def sweep_engine(self):
        if self.mesh is not None:  # no environment cache under a mesh
            return self._engine.sweep_engine(self.truncation_threshold)
        # allow_env_cache None: ADAPTAQC_ENVCACHE decides (off by default)
        return mps_core.sweep_engine(self.truncation_threshold,
                                     allow_env_cache=None)

    def zero_ref(self, compiler):
        n = compiler.full_circuit.num_qubits
        return self._zero(n, self.chi_for(n))

    # ----------------------------------------------------------- cost layer
    def evaluate_global_cost(self, compiler):
        """1 - |<0|psi>|^2 / <psi|psi> (aer_mps_backend.py:49-57 on the
        normalised state: long float32 chains drift in scale, not
        direction); softened, less alpha times the normalised Hamming-1
        overlap sum."""
        state = self.state_of(compiler)
        if not compiler.soften_global_cost:
            return float(self._engine.global_cost_normalized(state))
        cost, h1_sum = self._engine.softened_cost_terms(state)
        return float(cost) - softening_alpha(compiler) * float(h1_sum)

    def evaluate_local_cost(self, compiler):
        evals = self.measure_qubit_expectation_values(compiler)
        return float(0.5 * (1 - np.mean(evals)))

    def evaluate_circuit(self, compiler):
        return self.state_of(compiler)

    def measure_qubit_expectation_values(self, compiler):
        state = self.state_of(compiler)
        return self._engine.z_expectations(state).cpu().numpy().tolist()

    # -------------------------------------------------------- analysis layer
    def all_pair_rdms(self, state, pairs):
        """Host (4, 4) RDMs of the pairs (lower qubit as the low bit), read
        off one device-side (n, n, 4, 4) sweep."""
        rhos = self._engine.all_pair_rdms(state).cpu().numpy()
        return [rhos[min(a, b), max(a, b)]
                for a, b in np.asarray(pairs).reshape(-1, 2).tolist()]

    def two_qubit_rdm(self, circuit_or_compiler, q1, q2, state=None):
        if state is None:
            state = self.state_of(circuit_or_compiler)
        return self.all_pair_rdms(state, [(q1, q2)])[0]

    def mps_from_compiler_target(self, circuit: Circuit, start_state=None):
        """Simulate a target circuit into an engine MPS (the reference's
        mps_from_circuit precompute)."""
        n = circuit.num_qubits
        state = (start_state if start_state is not None
                 else self.initial_state(circuit, n))
        start = 1 if (circuit.data and circuit.data[0].name in
                      ("set_mps", "set_statevector")) else 0
        tape = compile_tape(circuit, (start, len(circuit.data)))
        return self.run_tape(state, tape)


def mps_backend_with_args(mps_truncation_threshold=DEFAULT_TRUNCATION_THRESHOLD,
                          max_chi=None, mps_log_data=False, device="cuda",
                          dtype=None, **_ignored) -> MPSBackend:
    """mps_sim_with_args analogue (aer_mps_backend.py:27-42)."""
    return MPSBackend(mps_truncation_threshold, max_chi, mps_log_data,
                      device=device, dtype=dtype)


class SamplingBackend(AQCBackend):
    """Shot-based cost estimates: counts drawn from the statevector
    engine's |psi|^2 (QiskitSamplingBackend analogue, the "QASM" backend).

    :param shots: shots of every estimate.
    :param seed: seeds both generators: the torch.Generator of the draws on
        the device, and `host_rng` (numpy) for tomography and noise
        trajectories.
    :param device: torch device of the statevector engine and the draws.
    :param dtype: complex dtype of the statevector engine.
    """

    engine_name = "sampling"

    def __init__(self, shots: int = 8192, seed: int = 0, device="cuda",
                 dtype: torch.dtype = None):
        self.shots = shots
        self._sv = SVBackend(device, dtype)
        self.device = self._sv.device
        self.dtype = self._sv.dtype
        self.seed = seed
        self._generator = None
        self.host_rng = np.random.default_rng(seed)

    # engine plumbing delegates to the statevector engine
    def initial_state(self, circuit, n):
        return self._sv.initial_state(circuit, n)

    def run_tape(self, state, tape):
        return self._sv.run_tape(state, tape)

    def run_tape_adjoint(self, state, tape):
        return self._sv.run_tape_adjoint(state, tape)

    def state_of(self, compiler):
        return compiler._current_state()

    def sweep_engine(self):
        return None  # shot-based costs have no closed-form probe

    def zero_ref(self, compiler):
        return self._sv.zero_ref(compiler)

    # --------------------------------------------------------------- draws
    @property
    def generator(self) -> torch.Generator:
        """The draws' torch.Generator on the backend's device, seeded with
        `seed`; made at first use, so that building a backend (the module
        singleton QASM_SIM included) touches no device."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.seed)
        return self._generator

    def sample_state(self, state, shots: int, n: int):
        """Counts {bitstring: count} of `shots` draws from |state|^2, qubit
        0 as the rightmost character (qiskit's order).

        The draws are made on the state's device by inverse CDF: uniform
        numbers from this backend's generator, searched in the float64
        cumulative sum of |psi|^2. Only the `shots` indices come back to
        the host. (torch.multinomial takes at most 2**24 categories.)"""
        cdf = torch.cumsum(sv_core.probabilities(state).to(torch.float64), 0)
        u = torch.rand(shots, generator=self.generator, dtype=torch.float64,
                       device=state.device) * cdf[-1]
        draws = torch.searchsorted(cdf, u, right=True).clamp_(
            max=cdf.numel() - 1)
        vals, cnts = np.unique(draws.cpu().numpy(), return_counts=True)
        return {format(int(v), f"0{n}b"): int(c) for v, c in zip(vals, cnts)}

    def noisy_counts(self, circuit: Circuit, noise_model, shots: int,
                     num_trajectories: int = 8):
        """Counts of a circuit under a thermal-relaxation noise model: the
        shots are split across Monte-Carlo Kraus trajectories, each
        simulated exactly on the host in float64
        (circuits/running.simulate_noise_trajectory, drawing from
        `host_rng`), then sampled on the device."""
        from ..circuits.running import simulate_noise_trajectory
        per_traj = [shots // num_trajectories] * num_trajectories
        per_traj[0] += shots - sum(per_traj)
        merged = {}
        for traj_shots in per_traj:
            if traj_shots == 0:
                continue
            sv = simulate_noise_trajectory(circuit, noise_model,
                                           self.host_rng)
            state = torch.as_tensor(sv, dtype=self.dtype, device=self.device)
            for key, c in self.sample_state(state, traj_shots,
                                            circuit.num_qubits).items():
                merged[key] = merged.get(key, 0) + c
        return merged

    def counts(self, compiler, shots: Optional[int] = None,
               num_trajectories: int = 8):
        """Sampled counts of the compiler's full circuit; with a noise
        model in its execute_kwargs, under that model."""
        from ..circuits.operations import make_quantum_only_circuit
        shots = shots or self.shots
        execute_kwargs = getattr(compiler, "execute_kwargs", None) or {}
        noise_model = execute_kwargs.get("noise_model")
        if noise_model is not None:
            return self.noisy_counts(
                make_quantum_only_circuit(compiler.full_circuit), noise_model,
                shots, num_trajectories)
        return self.sample_state(self.state_of(compiler), shots,
                                 compiler.full_circuit.num_qubits)

    # ----------------------------------------------------------- cost layer
    def evaluate_global_cost(self, compiler):
        if compiler.soften_global_cost:
            raise NotImplementedError(
                "soften_global_cost is currently only implemented for "
                "MPSBackend")
        counts = self.counts(compiler)
        zero = "0" * compiler.full_circuit.num_qubits
        return 1.0 - counts.get(zero, 0) / sum(counts.values())

    def evaluate_local_cost(self, compiler):
        evals = self.measure_qubit_expectation_values(compiler)
        return float(0.5 * (1 - np.mean(evals)))

    def evaluate_circuit(self, compiler):
        return self.counts(compiler)

    def measure_qubit_expectation_values(self, compiler):
        counts = self.counts(compiler)
        n = compiler.full_circuit.num_qubits
        evals = np.zeros(n)
        total = sum(counts.values())
        for bitstring, c in counts.items():
            for q in range(n):
                evals[q] += (1 if bitstring[n - 1 - q] == "0" else -1) * c
        return list(evals / total)

    # -------------------------------------------------------- analysis layer
    def all_pair_rdms(self, state, pairs):
        """Shot-based tomography RDMs: the exact per-pair RDMs fix the
        outcome distributions of the 9 Pauli settings, and multinomial
        draws from those (host_rng) stand for running the measurement
        circuits (entanglement_measures.sample_tomography_rdm)."""
        from ..utils.entanglement_measures import sample_tomography_rdm
        exact = self._sv.all_pair_rdms(state, pairs)
        return [sample_tomography_rdm(rho, self.shots, self.host_rng)
                for rho in exact]

    def two_qubit_rdm(self, circuit_or_compiler, q1, q2, state=None):
        from ..utils.entanglement_measures import sample_tomography_rdm
        if state is None:
            state = self.state_of(circuit_or_compiler)
        exact = self._sv.two_qubit_rdm(None, q1, q2, state=state)
        return sample_tomography_rdm(exact, self.shots, self.host_rng)


class CenterMPSBackend(AQCBackend):
    """The independent second MPS engine behind the backend contract: the
    ITensorBackend analogue (itensor_backend.py:17-62), there to
    cross-check the primary MPS engine with an algorithmically independent
    one. `center_mps.py` is a mixed-canonical (orthogonality-center) engine
    that shares no gauge convention or update algebra with `mps_core.py`.

    Against itensor_backend.py:
      - the constructor takes (chi, cutoff) as :18 does (there chi=10_000,
        cutoff=1e-14); fixed tensor shapes need a finite chi, so the default
        is DEFAULT_MAX_CHI;
      - evaluate_global_cost is 1 - the overlap with zero of the normalised
        state (:34-42) and raises for soften_global_cost as :35-38 does;
      - evaluate_circuit returns the engine state (:47-59);
      - the reference raises for the local cost and expectation values
        (:44-45, :61-62); here both work, and so does ISL pair selection
        through all_pair_rdms;
      - it has a sweep engine, so costs are optimised by the device sweeps
        rather than by one re-simulation a query.

    :param device: torch device of every engine state ("cuda" unless the
        caller asks for the CPU).
    :param dtype: complex dtype of the engine (complex64 by default).
    """

    engine_name = "center_mps"

    def __init__(self, chi: Optional[int] = None, cutoff: float = 1e-14,
                 device="cuda", dtype: torch.dtype = None):
        self.chi = chi
        self.cutoff = float(cutoff)
        self.device = torch.device(device)
        self.dtype = dtype or config.DEFAULT_DTYPE

    def chi_for(self, n: int) -> int:
        cap = self.chi or DEFAULT_MAX_CHI
        return int(min(cap, max(2, 2 ** ((n + 1) // 2))))

    # ------------------------------------------------------- engine plumbing
    def initial_state(self, circuit: Circuit, n: int):
        chi = self.chi_for(n)
        kw = dict(dtype=self.dtype, device=self.device)
        if circuit.data and circuit.data[0].name == "set_mps":
            raise ValueError(
                "CenterMPSBackend takes gate-circuit targets (the reference "
                "ITensorBackend likewise prepares its own target MPS)")
        if circuit.data and circuit.data[0].name == "set_statevector":
            return center_mps.from_bform(
                mps_core.from_dense(circuit.data[0].payload, chi, **kw))
        return center_mps.zero_cmps(n, chi, **kw)

    def run_tape(self, state, tape: Tape):
        return center_mps.apply_tape(state, tape.kinds, tape.q0, tape.q1,
                                     tape.angles, self.cutoff)

    def run_tape_adjoint(self, state, tape: Tape):
        return center_mps.apply_tape_adjoint(state, tape.kinds, tape.q0,
                                             tape.q1, tape.angles,
                                             self.cutoff)

    def state_of(self, compiler):
        return compiler._current_state()

    def sweep_engine(self):
        return center_mps.sweep_engine(self.cutoff)

    def zero_ref(self, compiler):
        n = compiler.full_circuit.num_qubits
        return center_mps.zero_cmps(n, self.chi_for(n), self.dtype,
                                    self.device)

    @staticmethod
    def truncated_weight(state) -> float:
        return float(state.trunc)

    # ----------------------------------------------------------- cost layer
    def evaluate_global_cost(self, compiler):
        if compiler.soften_global_cost:
            raise NotImplementedError(
                "soften_global_cost is currently only implemented for "
                "MPSBackend")  # itensor_backend.py:35-38
        return float(center_mps.global_cost_normalized(
            self.state_of(compiler)))

    def evaluate_local_cost(self, compiler):
        evals = self.measure_qubit_expectation_values(compiler)
        return float(0.5 * (1 - np.mean(evals)))

    def evaluate_circuit(self, compiler):
        return self.state_of(compiler)

    def measure_qubit_expectation_values(self, compiler):
        return center_mps.z_expectations(
            self.state_of(compiler)).cpu().numpy().tolist()

    # -------------------------------------------------------- analysis layer
    def all_pair_rdms(self, state, pairs):
        rhos = center_mps.all_pair_rdms(state).cpu().numpy()
        return [rhos[min(a, b), max(a, b)]
                for a, b in np.asarray(pairs).reshape(-1, 2).tolist()]

    def two_qubit_rdm(self, circuit_or_compiler, q1, q2, state=None):
        if state is None:
            state = self.state_of(circuit_or_compiler)
        return self.all_pair_rdms(state, [(q1, q2)])[0]


# default backends (python_default_backends.py:17-19; CENTER_MPS_SIM is the
# ITENSOR_SIM analogue, julia_default_backends.py:13), on the card
SV_SIM = SVBackend()
MPS_SIM = MPSBackend()
QASM_SIM = SamplingBackend()
CENTER_MPS_SIM = CenterMPSBackend()
