"""Training traffic: the window drives the port's `train_step(batch)`.

Set-up builds one training step (`flipped_tpu_torch.train.step.
make_train_step` over the port's model and AdamW), drives it through its
first `check_steps` updates on distinct batches of the pool (these warm
it up too), and keeps what the reference is compared with: each update's
losses, the first gradient as AdamW holds it after one update (its first
moment over 1 - beta1), and the trainables after the last of them. The
window goes on with the same object and the pool's next batches.

A unit of work is one optimizer update of accum_iter x batch_size
examples, ended by a synchronize.
"""
from __future__ import annotations

import gc

import torch

from pbcore import checks, counts, program, traffic


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.samples = self.t["batch_size"] * self.t["accum_iter"]

    def setup(self):
        from flipped_tpu_torch.train.optim import make_optimizer
        from flipped_tpu_torch.train.step import make_train_step
        ctx, t = self.ctx, self.t
        with ctx.spans("draw"):
            self.pool = traffic.make_pool("train", ctx.config, t, ctx.seed)
            self.model, run_cfg = program.build(ctx.config, t, ctx.seed,
                                                ctx.device, ctx.quantize)
            self.opt = make_optimizer(self.model, run_cfg.train,
                                      t["steps_per_epoch"], self.samples)
            step = make_train_step(self.model, self.opt, vaq=t["vaq"],
                                   qav=t["qav"])
            self.step = _faulty(step, self.opt, ctx.fault)
        with ctx.spans("copy-in"):
            self.batches = [program.to_device(b, ctx.device)
                            for b in self.pool]
        named = self.opt.named
        start = {k: p.detach().clone() for k, p in named.items()}
        self.prog = {"losses": []}
        for i in range(t["check_steps"]):
            with ctx.spans("step"):
                m = self.step(self.batches[i])
            self.prog["losses"].append({"vqa": float(m.vqa_loss),
                                        "vaq": float(m.vaq_loss),
                                        "qav": float(m.qav_loss)})
            if i == 0:
                state = self.opt.adamw.state
                self.prog["grad1"] = {
                    k: float(torch.linalg.vector_norm(
                        state[p]["exp_avg"] / (1 - 0.9)))
                    if p in state else 0.0 for k, p in named.items()}
        self.prog["change"] = {
            k: float(torch.linalg.vector_norm(p.detach() - start[k]))
            for k, p in named.items()}
        self.next = t["check_steps"]

    def unit(self) -> int:
        batch = self.batches[self.next % len(self.batches)]
        self.next += 1
        with self.ctx.spans("step"):
            self.step(batch)
        with self.ctx.spans("sync"):
            self.ctx.sync()
        return self.samples

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"train_samples_per_s": units * self.samples / seconds}

    def counters(self, units: int) -> dict:
        cfg, t = self.ctx.config, self.t
        return {"units": units,
                "flops": {k: v * units for k, v in
                          counts.train_update_flops(cfg, t).items()},
                "linear_least_s": units * counts.product_least_seconds(
                    counts.train_linear_products(cfg, t), self.ctx.peaks)}

    def release(self):
        del self.model, self.opt, self.step, self.batches
        gc.collect()
        torch.cuda.empty_cache()

    def answers(self) -> dict:
        return self.prog


def reference(ctx, sess) -> dict:
    """The float32 reference's readings of the same updates, from the
    same draw and the same batches."""
    from reference.model import Reference, strict_fp32
    from reference.train import follow
    t = ctx.traffic
    batches = [program.to_device(b, ctx.device)
               for b in sess.pool[:t["check_steps"]]]
    with strict_fp32():
        ref = Reference(ctx.config, t["bias"], ctx.seed, ctx.device,
                        act_levels=ctx.ref_act_levels)
        got = follow(ref, batches, t, t["check_steps"],
                     rows=t["reference_rows"])
    del ref
    return got


def compare(prog: dict, ref: dict) -> dict:
    return checks.train_readings(prog, ref)


def _faulty(step, opt, fault):
    """The step as the window drives it, or broken underneath for the
    fault tests: 'unchanged' returns the trainables and AdamW's state as
    they were; 'half_batch' leaves out the second half of each
    microbatch, the mean taken over the rest."""
    if fault is None:
        return step
    if fault == "half_batch":
        return lambda batch: step({k: v[:, :v.shape[1] // 2]
                                   for k, v in batch.items()})
    if fault == "unchanged":
        def unchanged(batch):
            params = [p.detach().clone() for p in opt.params]
            m = step(batch)
            with torch.no_grad():
                for p, was in zip(opt.params, params):
                    p.copy_(was)
            opt.adamw.state.clear()
            return m
        return unchanged
    raise ValueError(f"unknown fault {fault!r}")
