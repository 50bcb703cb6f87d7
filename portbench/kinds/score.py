"""Scoring: one caller scores a batch of users' held-out streams, call
after call, each call timed to its synchronise: the model's forward
(``predict``, the same layers and kernels as its ``loss`` under the
configuration's ``attn_impl``) under ``torch.inference_mode``, then the
negative log-likelihood of every target position in float32.  That last
step (the f32 cast, logsumexp and gather over the logits) is the
benchmark's own code, timed with the call: the port has no entry that
returns each position's score, and its ``loss`` returns only their mean.

Traffic keys: ``users`` (streams a call), ``positions`` (scored
positions a stream), ``pool`` (distinct batches drawn from the seed; the
calls take them in turn), ``check_users`` (rows of each batch that the
check compares, drawn from the seed), ``warm_calls``, ``trace_units``
(calls profiled in a traced run).

``correct``: every call's scores in the window, on the rows drawn for
the check, against the plain reference's on the same rows:
``nll_rms_gap``, the largest over the calls of |scores - reference| /
|reference| (2-norms over the positions), and ``nll_max_gap``, the
largest gap at any one position; a call with a score that is not finite
in any row has failed.  Rows do not interact, so the drawn rows stand
for the batch.  A mean loss would not do: averaged over tens of
thousands of positions, the gaps of a lower precision cancel, and the
control reads no higher than the program.
"""
from __future__ import annotations

import importlib
import math
import time

from portbench import streams, weights, work


class Score:
    unit = "call"

    def __init__(self, ctx):
        torch, port = ctx.torch, ctx.port
        self.ctx, self.torch = ctx, torch
        cfg, tr = ctx.cfg, ctx.traffic
        self.model = port.build_model(ctx.model_cfg)
        self.layout = self.model.init(None, device="meta")
        self.params = weights.make_params(self.layout, cfg, ctx.seed,
                                          ctx.device)
        ctx.sync()
        ctx.log("weights made")
        k = cfg.get("num_audio_codebooks", 0)
        self.pool = [{key: torch.from_numpy(v).to(ctx.device)
                      for key, v in b.items()}
                     for b in streams.score_batches(ctx.seed, tr,
                                                    cfg["vocab_size"], k)]
        self.rows = [torch.from_numpy(r).to(ctx.device)
                     for r in streams.check_rows(ctx.seed, tr)]
        self.positions = tr["users"] * tr["positions"]
        ctx.log("traffic made")
        self.answers = []
        self.calls = 0
        for _ in range(tr["warm_calls"]):
            self.step()
            ctx.log("a warm-up call done")
        self.answers, self.calls = [], 0

    def step(self) -> float:
        torch = self.torch
        batch = self.pool[self.calls % len(self.pool)]
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits = self.model.predict(self.params, batch).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                batch["targets"].long()[..., None])[..., 0]
            answer = logz - gold
            del logits
        self.ctx.sync()
        dt = time.perf_counter() - t0
        self.answers.append(answer)
        self.calls += 1
        return dt

    def end_to_end(self, lat, window_s):
        return {"eval_tokens_per_s": (len(lat) * self.positions / window_s,
                                      "tokens/s")}

    def work(self, calls: int):
        cfg, tr = self.ctx.cfg, self.ctx.traffic
        b, sl = tr["users"], tr["positions"]
        out = {"model_flops": calls * work.forward_flops(cfg, b, sl)}
        if cfg.get("attn_impl") == "pallas":
            per = calls * cfg["num_layers"]
            if cfg["family"] == "ssm":
                out["ssd_bound_s"] = per * work.ssd_launch_bound_s(cfg, b, sl)
            else:
                out["flash_bound_s"] = per * work.flash_launch_bound_s(
                    cfg, b, sl)
        return out

    def free(self):
        """The program's own objects go; the benchmark's inputs (weights,
        batches) stay for the reference."""
        self.model = None

    def reference_scores(self, num=None):
        """The plain reference's scores of the check's rows of each batch
        of the pool (``num``: its numerics; float32 by default)."""
        torch = self.torch
        ref = importlib.import_module(
            f"portbench.reference.{self.ctx.cfg['reference']}")
        from portbench.reference.common import EXACT, exact_matmuls
        with torch.no_grad(), exact_matmuls():
            return [ref.scores(self.params,
                               {k: v[rows] for k, v in b.items()},
                               self.ctx.cfg, num or EXACT)
                    for b, rows in zip(self.pool, self.rows)]

    def check(self, limits):
        failed = sum(not bool(self.torch.isfinite(a).all())
                     for a in self.answers)
        gaps = score_gaps(self.answers, self.reference_scores(), self.rows)
        return {k: {"value": v, "limit": limits[k]}
                for k, v in gaps.items()}, failed

    def readings(self, limits, control: bool):
        """The check's numbers on one call of each pool batch, and with
        ``control`` the same numbers for the reference in fp8 put in the
        program's place."""
        self.answers, self.calls = [], 0
        for _ in self.pool:
            self.step()
        got = self.answers
        self.free()
        want = self.reference_scores()
        out = {"program": score_gaps(got, want, self.rows)}
        if control:
            from portbench.reference.common import Numerics
            out["control"] = score_gaps(
                self.reference_scores(Numerics(fp8=True)), want)
        return out


def score_gaps(got, want, rows=None):
    """Over the calls (call i scored pool batch i mod pool; ``rows[i mod
    pool]`` picks the rows of its scores that ``want`` holds, or all of
    them): the largest relative 2-norm gap and the largest gap at one
    position; infinite if a reading is not finite or there is none."""
    rms = big = -1.0
    for i, g in enumerate(got):
        w = want[i % len(want)]
        if rows is not None:
            g = g[rows[i % len(rows)]]
        d = (g.float() - w).abs()
        if not bool(d.isfinite().all()):
            return {"nll_rms_gap": math.inf, "nll_max_gap": math.inf}
        rms = max(rms, float(d.norm() / w.norm()))
        big = max(big, float(d.max()))
    if rms < 0:
        return {"nll_rms_gap": math.inf, "nll_max_gap": math.inf}
    return {"nll_rms_gap": rms, "nll_max_gap": big}


def start(ctx):
    return Score(ctx)
