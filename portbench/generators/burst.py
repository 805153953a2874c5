"""Bursts of new pending pods: ``pods`` of them a wave, each drawn from the
traffic's ``mix``, none in a PodGroup."""

from __future__ import annotations

import numpy as np

from portbench.generators._cluster import (Base, Burst, draw_mix,
                                           make_pods, rng_for)


def wave(base: Base, config: dict, traffic: dict, seed: int,
         index: int) -> Burst:
    """Wave ``index`` of a run (-1: the warm-up wave), new objects with
    names and tie-break keys of their own."""
    n = traffic["pods"]
    mix = draw_mix(traffic["mix"], n, config["services"],
                   rng_for(seed, 1, index + 1))
    tag = "warm" if index < 0 else f"w{index}"
    names = [f"{tag}-{i:05d}" for i in range(n)]
    uids = [f"{seed}-{tag}-{i:05d}" for i in range(n)]
    return make_pods(base, mix, names, uids, np.full(n, -1), [], 0)
