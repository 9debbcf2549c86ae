"""GOSS — gradient-based one-side sampling (counterpart of
lightgbm_tpu/boosting/goss.py; reference: src/boosting/goss.hpp:30-217).

Every iteration after the first ``1 / learning_rate`` keeps the
``top_rate`` share of rows by |g·h|, draws ``other_rate`` of the rest with
probability ``other_k / rest_k`` and multiplies the drawn rows' g and h
by ``(N - top_k) / other_k``; the kept rows are the grower's sample mask.
The JAX package's draw, ``jax.random.uniform(fold_in(PRNGKey(
bagging_seed), it), (N,))``, is reproduced bit for bit on the training
device (``utils/random.py``), so both packages keep the same rows.
"""
from __future__ import annotations

import torch

from ..utils import log
from ..utils.random import fold_in, prng_key, uniform_f32
from .gbdt import GBDT


class GOSS(GBDT):

    def init(self, config, train_ds, objective, metrics, device) -> None:
        super().init(config, train_ds, objective, metrics, device)
        if config.top_rate + config.other_rate > 1.0:
            log.fatal("top_rate + other_rate should be <= 1.0 in GOSS")
        if config.top_rate <= 0.0 or config.other_rate <= 0.0:
            log.fatal("top_rate and other_rate should be positive in GOSS")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
        log.info("Using GOSS")
        self._key = prng_key(config.bagging_seed)

    def _sample(self, it: int, g, h):
        """(g, h) of iteration ``it``, amplified where drawn; sets the
        sample mask (reference: goss.hpp:91-146)."""
        N = self.train_ds.num_data
        if it < int(1.0 / self.config.learning_rate):
            self._bag_mask = torch.ones(N, dtype=torch.float32,
                                        device=self.device)
            return g, h
        top_k = max(1, int(N * self.config.top_rate))
        other_k = max(1, int(N * self.config.other_rate))
        multiply = (N - top_k) / other_k
        weight = torch.abs(g * h)
        threshold = torch.topk(weight, top_k, sorted=False).values.min()
        is_top = weight >= threshold
        # f32 division, as jnp divides a Python int by an int32 count
        rest_k = torch.clamp((~is_top).sum(), min=1).to(torch.float32)
        prob = torch.tensor(float(other_k), dtype=torch.float32,
                            device=self.device) / rest_k
        unif = uniform_f32(fold_in(self._key, it), N, self.device)
        sampled = ~is_top & (unif < prob)
        self._bag_mask = (is_top | sampled).to(torch.float32)
        amp = torch.where(sampled, torch.tensor(multiply, dtype=torch.float32,
                                                device=self.device),
                          torch.ones((), dtype=torch.float32,
                                     device=self.device))
        return g * amp, h * amp
