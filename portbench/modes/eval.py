"""Eval traffic: the window drives the port's cached scorer,
`eval_step(batch, span_info)` from `make_eval_step(cached=True)`, over the
pool's batches in turn, each with the span its packer computes on the
host, fetching the predictions to the host as the eval loop does.

A unit of work is one batch of batch_size examples. The host runs ahead
of the card: each batch's predictions (and scores) are copied to pinned
host memory behind the step, and read only once more than the traffic's
`ahead` batches are in flight, so a stall of the host is absorbed while
the card works through what was sent; `drain()` waits for all of it,
and the window's clock is read after that wait.

The scores of each pool batch's first pass are kept; after the window a
sample of rows,
drawn from the seed among the batches that ran, is scored again by the
float32 reference, every option by a whole forward pass, and the share
of scores off by more than the cell's tolerance is compared.
"""
from __future__ import annotations

import collections
import gc

import numpy as np
import torch

from pbcore import counts, program, traffic


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic

    def setup(self):
        from flipped_tpu_torch.train.step import bucket_span, make_eval_step
        ctx, t = self.ctx, self.t
        with ctx.spans("draw"):
            self.pool = traffic.make_pool("eval", ctx.config, t, ctx.seed)
            self.model, _ = program.build(ctx.config, t, ctx.seed,
                                          ctx.device, ctx.quantize)
            self.step = make_eval_step(self.model, cached=True)
        self.spans_info = [traffic.eval_span(b["vqa_labels"], b["prefix"])
                           for b in self.pool]
        self.span = max(bucket_span(n, t["max_seq_len"])
                        for n, _ in self.spans_info)
        with ctx.spans("copy-in"):
            self.batches = [program.to_device(b, ctx.device)
                            for b in self.pool]
        self.scores = {}
        self.flight = collections.deque()    # (batch, prediction, scores, event)
        self.next = 0
        self._dispatch(0)                     # warm-up on the cell's shapes
        self.drain()
        self.scores.clear()

    def _dispatch(self, i: int) -> int:
        with self.ctx.spans("step"):
            out = self.step(self.batches[i], span_info=self.spans_info[i])
        keep = i not in self.scores and all(f[0] != i for f in self.flight)
        with self.ctx.spans("copy-out"):
            pred = _to_host(out["prediction"])
            scores = _to_host(out["scores"].float()) if keep else None
            event = None
            if out["scores"].is_cuda:
                event = torch.cuda.Event()
                event.record()
        self.flight.append((i, pred, scores, event))
        while len(self.flight) > self.t["ahead"]:
            self._collect()
        return self.t["batch_size"]

    def _collect(self):
        """Waits for the oldest batch in flight and keeps its scores."""
        i, _, scores, event = self.flight.popleft()
        with self.ctx.spans("fetch"):
            if event is not None:
                event.synchronize()
        if scores is not None:
            self.scores[i] = _fault(scores, self.ctx.fault)

    def unit(self) -> int:
        i = self.next % len(self.batches)
        self.next += 1
        return self._dispatch(i)

    def drain(self):
        """Waits for every batch sent."""
        while self.flight:
            self._collect()

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"eval_samples_per_s": units * self.t["batch_size"] / seconds}

    def counters(self, units: int) -> dict:
        return {"units": units, "flops": {
            k: v * units for k, v in counts.eval_batch_flops(
                self.ctx.config, self.t, self.span).items()}}

    def release(self):
        self.drain()
        del self.model, self.step, self.batches
        gc.collect()
        torch.cuda.empty_cache()

    def answers(self) -> dict:
        """The window's scores of the sampled rows (NaN where the program
        gave none)."""
        picks = traffic.sample_rows(self.ctx.seed, self.scores,
                                    self.t["batch_size"], self.t["check_rows"])
        got = []
        for i, r in picks:
            s = self.scores[i]
            got.append(s[r] if r < s.shape[0] else
                       torch.full_like(s[0], float("nan")))
        return {"picks": picks, "scores": torch.stack(got)}


def reference(ctx, sess) -> dict:
    """The float32 reference's scores of the same rows, every option by a
    whole forward pass."""
    from reference.model import Reference, strict_fp32
    from reference.serve import option_scores
    picks = sess.answers()["picks"]
    rows = {k: np.stack([sess.pool[i][k][r] for i, r in picks])
            for k in ("video", "vqa_tokens", "vqa_labels",
                      "vqa_video_start", "vqa_splice")}
    with strict_fp32(), torch.no_grad():
        ref = Reference(ctx.config, ctx.traffic["bias"], ctx.seed,
                        ctx.device, act_levels=ctx.ref_act_levels)
        want = option_scores(ref, program.to_device(rows, ctx.device))
        del ref
    return {"picks": picks, "scores": want.cpu(),
            "tolerance": ctx.cell.spec["tolerance"]}


def gaps(prog: dict, ref: dict) -> torch.Tensor:
    """The program's score less the reference's, for each sampled row's
    options (NaN where the program gave none)."""
    if prog["picks"] != ref["picks"]:
        return torch.full((1,), float("nan"))
    return (prog["scores"] - ref["scores"]).flatten()


def compare(prog: dict, ref: dict) -> dict:
    """score_off_share: the share of the sampled rows' option scores that
    lie further than the cell's tolerance (nats) from the reference's; a
    score the program did not give is off."""
    g = gaps(prog, ref)
    off = ~(g.abs() <= ref["tolerance"])
    return {"score_off_share": float(off.float().mean())}


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of x, made behind the card's work where x is on it."""
    if not x.is_cuda:
        return x.clone()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


def _fault(scores: torch.Tensor, fault):
    """The scores as produced, or broken for the fault tests: 'answer'
    alters each row's first option's score by half a nat, 'half_batch'
    leaves out half the rows."""
    if fault is None:
        return scores
    if fault == "answer":
        scores = scores.clone()
        scores[:, 0] += 0.5
        return scores
    if fault == "half_batch":
        return scores[:scores.shape[0] // 2]
    raise ValueError(f"unknown fault {fault!r}")
