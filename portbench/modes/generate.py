"""Generation traffic: the window drives the port's `gen_step(batch)` from
`make_generation_step` (one prefill, a Python loop of decode steps, the
option-embedding match) over the pool's batches in turn, fetching the
tokens and similarities to the host as the eval loop does.

A unit of work is one batch: batch_size rows of max_new_tokens greedy
tokens. Each pool batch's first tokens are kept; after the window a
sample of rows, drawn from the seed among the batches that ran, is read
by the float32 reference over each prompt with its served tokens: the
gap by which each served token's logit lies below the reference's best at
its position, and the share of positions whose gap passes the cell's
tolerance is compared.
"""
from __future__ import annotations

import gc

import torch

from pbcore import counts, program, traffic


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.eos = int(ctx.config["eos_token_id"])

    def setup(self):
        from flipped_tpu_torch.train.generation import make_generation_step
        ctx, t = self.ctx, self.t
        with ctx.spans("draw"):
            self.pool = traffic.make_pool("eval", ctx.config, t, ctx.seed)
            self.model, _ = program.build(ctx.config, t, ctx.seed,
                                          ctx.device, ctx.quantize)
            self.step = make_generation_step(self.model, self.eos,
                                             t["max_new_tokens"])
        with ctx.spans("copy-in"):
            self.batches = [program.to_device(b, ctx.device)
                            for b in self.pool]
        self.outputs = {}
        self.next = 0
        self._run(0)                          # warm-up on the cell's shapes
        self.outputs.clear()

    def _run(self, i: int) -> int:
        with self.ctx.spans("step"):
            out = self.step(self.batches[i])
        with self.ctx.spans("fetch"):
            generated = out["generated"].cpu()
            out["similarity"].cpu()
            if i not in self.outputs:
                self.outputs[i] = _fault(generated, self.ctx.fault)
        return self.t["batch_size"]

    def unit(self) -> int:
        i = self.next % len(self.batches)
        self.next += 1
        return self._run(i)

    def end_to_end(self, units: int, seconds: float) -> dict:
        t = self.t
        return {"gen_tokens_per_s":
                units * t["batch_size"] * t["max_new_tokens"] / seconds}

    def counters(self, units: int) -> dict:
        flops: dict = {}
        for i in range(units):
            prefix = int(self.pool[i % len(self.pool)]["prefix"].sum())
            for k, v in counts.generate_batch_flops(
                    self.ctx.config, self.t, prefix,
                    self.t["max_new_tokens"]).items():
                flops[k] = flops.get(k, 0.0) + v
        return {"units": units, "flops": flops}

    def release(self):
        del self.model, self.step, self.batches
        gc.collect()
        torch.cuda.empty_cache()

    def answers(self) -> dict:
        """The served tokens (rows, T) of the sampled rows; None where the
        program gave none."""
        picks = traffic.sample_rows(self.ctx.seed, self.outputs,
                                    self.t["batch_size"], self.t["check_rows"])
        served = []
        for i, r in picks:
            gen = self.outputs[i]
            if r >= gen.shape[0]:
                return {"picks": picks, "served": None}
            served.append(gen[r])
        return {"picks": picks, "served": torch.stack(served)}


def prompts(sess, picks, device):
    """Each picked row's prompt as tensors on `device`."""
    out = []
    for i, r in picks:
        host = sess.pool[i]
        row = {k: torch.as_tensor(host[k][r]).to(device) for k in
               ("video", "vqa_tokens", "vqa_labels", "prefix",
                "vqa_video_start", "vqa_splice")}
        out.append(row)
    return out


def reference(ctx, sess) -> dict:
    """The float32 reference over each sampled prompt with the tokens the
    window served: the logits at each served position (rows, T, V)."""
    from reference.model import Reference, strict_fp32
    from reference.serve import served_logits
    prog = sess.answers()
    if prog["served"] is None:
        return {"picks": prog["picks"], "logits": None,
                "tolerance": ctx.cell.spec["tolerance"]}
    logits = []
    with strict_fp32(), torch.no_grad():
        ref = Reference(ctx.config, ctx.traffic["bias"], ctx.seed,
                        ctx.device, act_levels=ctx.ref_act_levels)
        for row, served in zip(prompts(sess, prog["picks"], ctx.device),
                               prog["served"].to(ctx.device)):
            logits.append(served_logits(ref, {
                "tokens": row["vqa_tokens"][0], "prefix": row["prefix"],
                "video": row["video"], "video_start": row["vqa_video_start"],
                "splice": row["vqa_splice"]}, served))
        del ref
    return {"picks": prog["picks"], "logits": torch.stack(logits),
            "tolerance": ctx.cell.spec["tolerance"]}


def control_answers(ctx, sess, quantize: str) -> dict:
    """The control: at each served position of the sampled rows, the token
    that the program at `quantize` puts first, read teacher-forced by its
    prefill over the prompt and the tokens the window served."""
    prog = sess.answers()
    model, _ = program.build(ctx.config, ctx.traffic, ctx.seed, ctx.device,
                             quantize)
    firsts = []
    with torch.inference_mode():
        for row, served in zip(prompts(sess, prog["picks"], ctx.device),
                               prog["served"].to(ctx.device)):
            pre = int(row["prefix"])
            seq = torch.cat([row["vqa_tokens"][0][:pre], served[:-1]])[None]
            h, _, _ = model.prefill(seq, model.fuse(row["video"][None]),
                                    row["vqa_video_start"][None],
                                    row["vqa_splice"][None], seq.shape[1])
            firsts.append(model.lm_logits(h[:, pre - 1:])[0].argmax(-1))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"picks": prog["picks"], "served": torch.stack(firsts).cpu()}


def gaps(prog: dict, ref: dict) -> torch.Tensor:
    """At each served position of the sampled rows, the gap by which the
    served token's logit lies below the reference's best → (rows, T)."""
    if prog["served"] is None or ref["logits"] is None:
        return torch.full((1, 1), float("inf"))
    logits = ref["logits"]
    served = prog["served"].to(logits.device).long()
    got = logits.gather(-1, served[..., None])[..., 0]
    return (logits.max(-1).values - got).cpu()


def compare(prog: dict, ref: dict) -> dict:
    """gen_off_share: the share of the sampled rows' served positions at
    which the served token's logit lies further than the cell's tolerance
    below the reference's best."""
    g = gaps(prog, ref)
    return {"gen_off_share": float((~(g <= ref["tolerance"])).float().mean())}


def _fault(gen: torch.Tensor, fault):
    """The tokens as produced, or broken for the fault tests: 'token'
    alters the first generated token of every row, 'half_batch' leaves
    out half the rows."""
    if fault is None:
        return gen
    if fault == "token":
        gen = gen.clone()
        gen[:, 0] = (gen[:, 0] + 7) % 1000 + 1
        return gen
    if fault == "half_batch":
        return gen[:gen.shape[0] // 2]
    raise ValueError(f"unknown fault {fault!r}")
