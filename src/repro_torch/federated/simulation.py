"""The paper's synchronous federated round, end to end on one device.

Counterpart of ``repro.federated.simulation`` with the defaults of the
paper's protocol (§3): uniform selection of a fraction of the clients
(:class:`UniformPolicy`), local SGD for every selected client at once,
the Ds / Ld / Md criteria normalized over the round's participants, the
prioritized operator's Eq. 3 weights, and the commit
``w_G = sum_k p_k w_k`` (:class:`SyncStrategy`).  The server keeps the
flat representation: the round's client models are one ``[S, N]``
matrix, the Md criterion streams through the ``divergence_sq`` CUDA
kernel and the commit through the ``weighted_agg`` one.

Local training is ``torch.func.vmap(torch.func.grad(loss))`` over the
clients' stacked parameters, one step per batch of the round's plans —
the counterpart of the reference's ``vmap(scan(grad))``.  Evaluation is
LEAF-style: every eval point, the global model is tested on every
client's local test set; the global accuracy is the test-size-weighted
mean of the per-client accuracies.

Not ported yet (the reference's other ``FedSimConfig`` options):
device scenarios, other strategies and policies, Algorithm-1 online
adjustment, compression, meshes, DP accounting, deadlines and
checkpoints.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core.aggregate import AggregationConfig
from repro_torch.core.criteria import (ClientContext, criterion_needs,
                                       measure_criteria, normalize_criteria)
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.federated.draws import Draws, TorchDraws
from repro_torch.federated.engine import (RoundInputs, ServerState,
                                          SyncStrategy)
from repro_torch.federated.sampler import num_selected
from repro_torch.federated.selection import SelectionContext, UniformPolicy
from repro_torch.kernels import ops as kops
from repro_torch.optim.optimizers import sgd
from repro_torch.utils.pytree import FlatSpec, Params

# Test images per evaluation batch: bounds the activations held at once.
_EVAL_IMAGES = 4096


@dataclass(frozen=True)
class FedSimConfig:
    """Simulation hyper-parameters (the paper's values by default).

    ``online_adjust=True`` (Algorithm 1) is not ported yet and raises
    ``NotImplementedError``.
    """

    fraction: float = 0.1          # paper: 10% of clients per round
    batch_size: int = 10           # paper: B = 10
    local_epochs: int = 5          # paper: E = 5
    lr: float = 0.01               # paper: eta = 0.01
    max_rounds: int = 1000         # paper cap
    aggregation: AggregationConfig = field(default_factory=AggregationConfig)
    eval_every: int = 1            # rounds between evaluations
    seed: int = 0
    online_adjust: bool = False

    def __post_init__(self):
        if self.online_adjust:
            raise NotImplementedError(
                "online_adjust (Algorithm 1) is not ported to repro_torch yet")


@dataclass
class RoundMetrics:
    round: int
    global_acc: float              # size-weighted mean of local accuracies
    frac_above: Dict[float, float] # target acc -> fraction of devices above
    weights_entropy: float         # of the last round's Eq. 3 weights
    participants: int              # clients in the last round's wave
    sim_time: float = 0.0          # virtual clock at this eval point
    commits: int = 0               # global updates committed so far
    wall_time: float = 0.0         # host seconds since run() started


@dataclass
class SimResult:
    """``final_params`` is the model's parameter dict; ``final_state`` the
    engine carry, whose ``params`` is the flat vector."""

    metrics: List[RoundMetrics]
    final_params: Params
    rounds_to_target: Dict[Tuple[float, float], Optional[int]]
    # (target_acc, frac_devices) -> first round achieving it (None if never)
    final_state: Optional[ServerState] = None


class FederatedSimulation:
    """Server-side driver for the paper's experiments.

    ``loss_fn(params, images, labels)`` and ``acc_fn(params, images,
    labels, mask)`` take a parameter dict; ``init_params`` is moved to
    ``device``.  ``device`` is the GPU unless the caller asks for
    ``"cpu"``; with no GPU present the default raises.  ``draws``
    replaces the round's source of random draws (default
    :class:`TorchDraws` on ``device``, seeded by ``config.seed``).
    """

    def __init__(self, data: FederatedDataset, init_params: Params,
                 loss_fn: Callable, acc_fn: Callable, config: FedSimConfig,
                 draws: Optional[Draws] = None,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FederatedSimulation runs on the GPU by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        self.data = data
        self.cfg = config
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        self.draws = draws if draws is not None else TorchDraws(
            config.seed, self.device)
        self.strategy = SyncStrategy()
        self.policy = UniformPolicy()
        self.params = {k: v.to(self.device) for k, v in init_params.items()}
        self._fspec = FlatSpec(self.params)
        self._needs_update = any("update" in criterion_needs(n)
                                 for n in config.aggregation.criteria)

        dev = self.device
        self.images = torch.as_tensor(data.images, device=dev)
        self.labels = torch.as_tensor(data.labels, device=dev).long()
        self.counts = torch.as_tensor(data.counts, device=dev).long()
        self.t_images = torch.as_tensor(data.test_images, device=dev)
        self.t_labels = torch.as_tensor(data.test_labels, device=dev).long()
        self.t_counts = torch.as_tensor(data.test_counts, device=dev).long()
        max_t = self.t_images.shape[1]
        self._t_mask = (torch.arange(max_t, device=dev)[None, :]
                        < self.t_counts[:, None]).to(torch.float32)
        # [K, C] label histograms, fixed by the dataset (Ld's input)
        hist = np.stack([data.label_histogram(k)
                         for k in range(data.num_clients)])
        self._label_table = torch.as_tensor(hist, device=dev)

        self._num_sel = num_selected(data.num_clients, config.fraction)
        # every round runs the same number of local steps: enough for E
        # epochs of the largest client
        self._fixed_steps = max(
            1, int(data.counts.max()) // config.batch_size
        ) * config.local_epochs
        self._sgd = sgd(config.lr)
        self._grad = vmap(grad(loss_fn))

    # ------------------------------------------------------------------
    def init_state(self) -> ServerState:
        """Fresh engine carry for the current ``self.params``."""
        return self.strategy.init_state(self._fspec.ravel(self.params),
                                        self.data.num_clients)

    def _local_train(self, global_vec: torch.Tensor, sel: torch.Tensor,
                     plans: torch.Tensor) -> torch.Tensor:
        """E epochs of SGD for the selected clients at once → ``[S, N]``."""
        S = sel.shape[0]
        model = self._fspec.unravel(global_vec)
        stacked = {k: v.expand(S, *v.shape).contiguous()
                   for k, v in model.items()}
        images, labels = self.images[sel], self.labels[sel]
        rows = torch.arange(S, device=self.device)[:, None]
        for t in range(plans.shape[1]):
            idx = plans[:, t]                                   # [S, B]
            grads = self._grad(stacked, images[rows, idx], labels[rows, idx])
            stacked = self._sgd(stacked, grads)
        return self._fspec.stack_ravel(stacked)

    def _measure_criteria(self, stacked: torch.Tensor, sel: torch.Tensor,
                          params: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
        """``[S, m]`` criteria matrix, normalized over the participants.

        The update context is lazy: the streamed ``[S]`` squared norms
        ``||w_k - w_G||^2`` are computed only when a configured criterion
        declares ``needs=("update",)`` (Md does).
        """
        upd_sq = (kops.flat_divergence_sq(stacked, params)
                  if self._needs_update else None)
        ctx = ClientContext(num_examples=self.counts[sel],
                            label_counts=self._label_table[sel],
                            update_sq_norm=upd_sq)
        raw = measure_criteria(self.cfg.aggregation.criteria, ctx)
        return normalize_criteria(raw, mask)

    def _round_step(self, state: ServerState,
                    rnd: int) -> Tuple[ServerState, Dict[str, torch.Tensor]]:
        S = self._num_sel
        sel, dt_policy = self.policy.select(SelectionContext(
            draws=self.draws, num_clients=self.data.num_clients, n=S,
            rnd=rnd))
        sel = sel.to(self.device)
        plans = self.draws.batch_plans(rnd, self.counts[sel],
                                       self._fixed_steps,
                                       self.cfg.batch_size).to(self.device)
        stacked = self._local_train(state.params, sel, plans)
        # no device scenario: every selected client participates, and the
        # round lasts one time unit unless the policy saw completion times
        mask = contrib = torch.ones(S, device=self.device)
        dt = mask if dt_policy is None else dt_policy.to(self.device)
        c = self._measure_criteria(stacked, sel, state.params, mask)
        inp = RoundInputs(rnd=rnd, sel=sel, stacked=stacked, criteria=c,
                          mask=mask, contrib=contrib, dt=dt)
        state, ys = self.strategy.step(state, inp, self.cfg.aggregation)
        ys["participants"] = mask.sum()
        return state, ys

    def _evaluate(self, params_vec: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-client test accuracies ``[K]`` and the size-weighted
        global accuracy."""
        params = self._fspec.unravel(params_vec)
        per = max(1, _EVAL_IMAGES // self.t_images.shape[1])
        acc = vmap(self.acc_fn, in_dims=(None, 0, 0, 0))
        with torch.no_grad():
            accs = torch.cat([
                acc(params, self.t_images[i:i + per],
                    self.t_labels[i:i + per], self._t_mask[i:i + per])
                for i in range(0, self.data.num_clients, per)])
        w = self.t_counts.to(torch.float32)
        return accs, (accs * w).sum() / w.sum()

    # ------------------------------------------------------------------
    def run(self, targets: Tuple[float, ...] = (0.75, 0.80),
            device_fracs: Tuple[float, ...] = (0.2, 0.3, 0.4, 0.5, 0.7,
                                               0.75),
            log_every: int = 10, verbose: bool = True) -> SimResult:
        """Drive up to ``cfg.max_rounds`` rounds, evaluating every
        ``cfg.eval_every``.

        ``rounds_to_target[(t, f)]`` records the first eval round where at
        least a fraction ``f`` of the devices score ``>= t`` (``None`` if
        never); the loop stops early once every goal is met.
        """
        cfg = self.cfg
        block = max(1, cfg.eval_every)
        metrics: List[RoundMetrics] = []
        rounds_to: Dict[Tuple[float, float], Optional[int]] = {
            (t, f): None for t in targets for f in device_fracs}
        start = time.perf_counter()
        state = self.init_state()
        rnd = 0
        while rnd < cfg.max_rounds:
            n = min(block, cfg.max_rounds - rnd)
            for r in range(rnd + 1, rnd + n + 1):
                state, last = self._round_step(state, r)
            rnd += n
            accs, global_acc = self._evaluate(state.params)
            accs = accs.cpu().numpy()
            frac_above = {t: float(np.mean(accs >= t)) for t in targets}
            for t in targets:
                for f in device_fracs:
                    if rounds_to[(t, f)] is None and frac_above[t] >= f:
                        rounds_to[(t, f)] = rnd
            metrics.append(RoundMetrics(
                round=rnd, global_acc=float(global_acc),
                frac_above=frac_above,
                weights_entropy=float(last["entropy"]),
                participants=int(last["participants"]),
                sim_time=float(state.sim_time),
                commits=int(state.commits),
                wall_time=time.perf_counter() - start,
            ))
            if verbose and (rnd % log_every == 0 or rnd >= cfg.max_rounds):
                print(f"[round {rnd:4d}] acc={float(global_acc):.4f} "
                      f"frac>= {targets[0]:.0%}: "
                      f"{frac_above[targets[0]]:.2f}")
            if all(v is not None for v in rounds_to.values()):
                break
        self.params = self._fspec.unravel(state.params)
        return SimResult(metrics=metrics, final_params=self.params,
                         rounds_to_target=rounds_to, final_state=state)
