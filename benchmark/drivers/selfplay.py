"""Random-policy self-play on K4 (``ops/cuda_engine.selfplay_perpetual_kernel``).

A request plays ``tables`` tables of the configuration from a new first
deal for ``slots`` betting slots, in launches of ``slots_per_launch``,
with a Philox seed drawn from the run's seed and the request's index; the
program reads back the hands completed and the tables that overflowed.

The check is ``mcbench.tables.Engine``'s; ``check(control=True)`` puts
the reference's control (odd chips dropped, so chips are not conserved)
in the program's place. Work: hands, table slots.
"""

from __future__ import annotations

from mcbench import seeds, tables

MAIN_KERNEL = "mc_engine_prng_kernel"


class Driver(tables.Engine):
    def _run(self, key):
        from montecarlo_tpu_torch.ops import cuda_engine
        with self.span("req.selfplay"):
            state, hands, ovf = cuda_engine.selfplay_perpetual_kernel(
                seeds.kernel_seed(self.seed, "request", key), self.cfg,
                self.T, self.slots, self.per_launch, self.device)
        return state, hands, (hands, ovf)

    def _policy(self, control):
        return {"odd_chips": not control}
