"""Recommendation (port of ``flink_tpu/ml/recommendation.py``; FlinkML's
ALS matrix factorization).

Each half-step solves, for every user (then every item) at once,
``(sum_c v_c v_c^T + lambda I) x = sum_c r_c v_c``: the ``gram_accumulate``
kernel builds the Gram matrices and right-hand sides from the ratings
grouped by row (``rating_csr``) on a plan of chunks (``gram_plan``, on
the card), both once per fit and side, and the batched
solve is ``torch.linalg.solve`` (cuSOLVER on the card).  The initial
factors are the reference's draws from ``np.random.default_rng(seed)``.
Fitted state and ``predict`` are host numpy; ``fit`` runs on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flink_tpu_torch.device import DeviceLike, resolve_device
from flink_tpu_torch.kernels import gram_accumulate
from flink_tpu_torch.kernels.gram_accumulate import (GramPlan, gram_plan,
                                                     rating_csr)
from flink_tpu_torch.ml.pipeline import Estimator


class ALS(Estimator):
    fitted_params = ("user_factors", "item_factors", "_users", "_items")

    def __init__(self, num_factors: int = 10, lambda_: float = 0.1,
                 iterations: int = 10, seed: int = 0,
                 device: DeviceLike = None):
        self.num_factors = num_factors
        self.lambda_ = lambda_
        self.iterations = iterations
        self.seed = seed
        self.device = device
        self.user_factors = None
        self.item_factors = None
        self._users = None
        self._items = None

    def solve_side(self, fixed: torch.Tensor, indptr: torch.Tensor,
                   cols: torch.Tensor, vals: torch.Tensor,
                   plan: Optional[GramPlan] = None) -> torch.Tensor:
        """Factors [rows, f] of one side from the other side's ``fixed``
        and the ratings grouped by row (``plan``: their ``gram_plan``)."""
        grams, rhs = gram_accumulate(fixed, indptr, cols, vals, plan=plan)
        grams.diagonal(dim1=1, dim2=2).add_(self.lambda_)
        # the batched solve may return a column-major batch: the next
        # half-step's kernel reads the factors row-major
        return torch.linalg.solve(grams, rhs).contiguous()

    def fit(self, ratings, y=None):
        """ratings: iterable of (user, item, rating)."""
        triples = [tuple(r) for r in ratings]
        users = sorted({u for u, _, _ in triples})
        items = sorted({i for _, i, _ in triples})
        uidx = {u: i for i, u in enumerate(users)}
        iidx = {i: j for j, i in enumerate(items)}
        n_u, n_i, f = len(users), len(items), self.num_factors
        u = np.fromiter((uidx[a] for a, _, _ in triples), np.int32,
                        count=len(triples))
        it = np.fromiter((iidx[b] for _, b, _ in triples), np.int32,
                         count=len(triples))
        r = np.fromiter((float(c) for _, _, c in triples), np.float32,
                        count=len(triples))
        rng = np.random.default_rng(self.seed)
        dev = resolve_device(self.device)
        U = torch.from_numpy(rng.normal(0, 0.1, (n_u, f)).astype(np.float32)).to(dev)
        V = torch.from_numpy(rng.normal(0, 0.1, (n_i, f)).astype(np.float32)).to(dev)
        uj, ij, rj = (torch.from_numpy(a).to(dev) for a in (u, it, r))
        by_user = rating_csr(uj, ij, rj, n_u)
        by_item = rating_csr(ij, uj, rj, n_i)
        # the plans serve the kernel only: on the CPU nothing reads them
        on_card = dev.type == "cuda"
        plan_u = gram_plan(by_user[0]) if on_card else None
        plan_i = gram_plan(by_item[0]) if on_card else None
        for _ in range(self.iterations):
            U = self.solve_side(V, *by_user, plan=plan_u)
            V = self.solve_side(U, *by_item, plan=plan_i)
        self.user_factors = U.cpu().numpy()
        self.item_factors = V.cpu().numpy()
        self._users = uidx
        self._items = iidx
        return self

    def predict(self, pairs) -> np.ndarray:
        out = []
        for user, item in pairs:
            if user in self._users and item in self._items:
                out.append(float(
                    self.user_factors[self._users[user]]
                    @ self.item_factors[self._items[item]]))
            else:
                out.append(0.0)
        return np.asarray(out, np.float32)

    def empirical_risk(self, ratings) -> float:
        preds = self.predict([(u, i) for u, i, _ in ratings])
        truth = np.asarray([r for _, _, r in ratings], np.float32)
        return float(((preds - truth) ** 2).mean())
