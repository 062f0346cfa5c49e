"""Kind "lagrange_key": `api.crs_lagrange_form` (what `dump-lagrange`
computes) over a pool of monomial keys of distinct seeded tau made on the
card at set-up, in turn (closed loop, one client).  A key drawn from the
seed (one in the mix's `judge_every`) is kept whole and judged by the
reference (reference/bn254.py): lanes 0, n - 1 and `check_lanes` - 2
more drawn from the seed against [L_i(tau)] G, and the sum of all its
points against G (the Lagrange basis sums to one); every other key is
dropped as it comes, as a dump would.  The control derives the key of half
the domain from the same points: the configuration's domain is the
guarantee it breaks.

Mix parameters: `pool`, `warmup`, `check_lanes`, `judge_every`.
Configuration: `domain_log2`."""

import random

from portbench import workload
from portbench.reference import bn254


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 control: bool = False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.n = 1 << config["domain_log2"]
        self.derive = self.n // 2 if control else self.n
        self.taus = [workload.seeded_tau(seed, j) for j in range(traffic["pool"])]

    def setup(self) -> None:
        from plonkit_tpu_torch.api import crs_lagrange_form
        self.keys = [workload.device_key(self.config["domain_log2"], t, self.device)
                     for t in self.taus]
        for _ in range(self.traffic["warmup"]):
            crs_lagrange_form(self.keys[0], self.derive, device=self.device)

    def request(self, i: int):
        from plonkit_tpu_torch.api import crs_lagrange_form
        return crs_lagrange_form(self.keys[i % len(self.keys)], self.derive, device=self.device)

    def keep(self, i: int, key):
        if not workload.drawn(self.seed, i, self.traffic["judge_every"]):
            return None
        return tuple(a.copy() for a in key.g1_limbs())

    def release(self) -> None:
        self.keys = None
        workload.free(self.device)

    def judge(self, kept: list) -> tuple:
        """({"keys_refused": (keys with a lane or the sum wrong, 0)}, that
        count)."""
        lanes = self.traffic["check_lanes"]
        refused = 0
        for i, (x, y, inf) in kept:
            tau = self.taus[i % len(self.taus)]
            rng = random.Random(f"portbench:lanes:{self.seed}:{i}")
            at = sorted({0, self.n - 1, *rng.sample(range(1, self.n - 1), lanes - 2)})
            ok = x.shape[0] == self.n
            for lane, s in zip(at, bn254.lagrange_at(self.n, tau, at)):
                if not ok:
                    break
                got = None if inf[lane] else (bn254.ints_of_rows(x[lane:lane + 1])[0],
                                              bn254.ints_of_rows(y[lane:lane + 1])[0])
                ok = got == bn254.mul(bn254.G1, s)
            if ok:
                ok = bn254.sum_affine_rows(x, y, inf) == bn254.G1
            refused += not ok
        return {"keys_refused": (refused, 0)}, refused
