"""Closed-loop ``generate`` calls of a language model on the port's LM
path (``models.build`` -> ``serve.decode.generate``).

Set-up draws, from the seed: a pool of ``pool_batches`` prompt batches
(``batch`` rows of ``prompt_len`` tokens, the configuration's corpus kind),
then the model's weights (``init`` on the card), and runs one call as the
warm-up.  A step is one ``generate`` call on the next pool batch:
``new_tokens`` greedy tokens a row; a "query" is one prompt answered.

The check (``check``), after the window: the window's last batch is
replayed through the same ``generate`` with its logits kept, and held to
the configuration's plain reference (its full float32 forward over the
prompt and the generated tokens, on the program's weights) on
``check_rows`` rows drawn from the seed:

* ``replay_rows_differ``: rows whose replayed tokens differ from the
  window's;
* ``logit_rows_off``: rows whose logits at some generated position differ
  from the reference's by more than ``check.logit_tol``;
* ``token_rows_off``: rows with a chosen token whose reference logit lies
  below the reference's largest by more than ``check.token_tol``;
* ``expert_rows_off``: rows where, at some MoE layer, the program's
  ``moe_block`` on the reference's input to that layer (in the program's
  dtype) misses the reference's experts by more than ``check.expert_tol``
  of the output's norm, on some token whose top-k selection is clear (its
  k-th router log-probability ``check.route_margin`` or more above the
  next: a nearer tie may go either way at the program's precision).  The
  end-to-end logits carry the bf16 path's own spread; this one layer at a
  time is where a lower precision of the experts shows;
* ``ssm_rows_off``: the same for the Mamba mixers: rows where, at some
  Mamba layer, the program's ``ssm_block`` on the reference's input to
  that layer misses the reference's mixer by more than ``check.ssm_tol``
  of the output's norm on the row's 99th-percentile token.  A
  percentile, not the largest: bf16's rounding alone sends single tokens
  as far as a lower precision of the scan moves the bulk of them.

The controls (``lm_control.py``): ``program`` ``{"expert_dtype":
"float8_e4m3fn"}`` rounds the output of every MoE layer to that dtype;
``{"ssm_scan_dtype": "bfloat16"}`` runs the Mamba scan's state in that
dtype (the configuration states float32).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness

# config.json keys -> the port's config fields
FIELDS = {"hidden_size": "d_model", "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "intermediate_size": "d_ff",
          "vocab_size": "vocab_size", "num_hidden_layers": "n_layers",
          "num_experts": "n_experts", "num_experts_per_tok": "top_k",
          "mamba_d_state": "ssm_state", "mamba_dt_rank": "dt_rank",
          "mamba_expand": "ssm_expand", "mamba_d_conv": "ssm_conv",
          "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings",
          "attn_layer_period": "attn_layer_period",
          "attn_layer_offset": "attn_layer_offset",
          "expert_layer_period": "expert_layer_period",
          "expert_layer_offset": "expert_layer_offset"}
# config.json values the port's layers compute and no field selects
FIXED = {"hidden_act": "silu", "mamba_conv_bias": True,
         "mamba_proj_bias": False, "sliding_window": None}


def model_config(conf: dict):
    """The port's config of the configuration file: ``arch``'s, with every
    size the file gives."""
    from repro_torch.configs import get_config
    for key, want in FIXED.items():
        if conf[key] != want:
            raise ValueError(f"{key} = {conf[key]!r}: the port computes "
                             f"{want!r}")
    changes = {field: conf[key] for key, field in FIELDS.items()}
    changes["head_dim"] = conf.get("head_dim") \
        or conf["hidden_size"] // conf["num_attention_heads"]
    return dataclasses.replace(get_config(conf["arch"]), **changes,
                               dtype=conf["dtype"], param_dtype=conf["dtype"])


class Client:
    def __init__(self, bench: Path, config: dict, traffic: dict, *,
                 seed: int, device: torch.device,
                 program: dict | None = None):
        self.bench = bench
        self.cfg = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.program = program or {}
        self.n_steps = 0
        self.last = None
        self._restore = None

    # -- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.models import build
        from repro_torch.serve.decode import generate
        self.generate = generate
        tr, dev = self.traffic, self.device
        t0 = time.perf_counter()
        self.model_cfg = model_config(self.cfg)
        if "ssm_scan_dtype" in self.program:
            self.model_cfg = dataclasses.replace(
                self.model_cfg, ssm_scan_dtype=self.program["ssm_scan_dtype"])
        gen = torch.Generator(dev).manual_seed(self.seed)
        corpus = harness.load_module(
            self.bench, "corpora", self.cfg["corpus"]["kind"]).Corpus(
            self.cfg["corpus"], self.cfg["vocab_size"], gen, dev)
        self.pool = [corpus.draw(tr["batch"], tr["prompt_len"])
                     for _ in range(tr["pool_batches"])]
        if dev.type == "cuda":     # the peak from here on is the program's
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        self.bundle = build(self.model_cfg, device=dev)
        self.params = self.bundle.init((self.seed + 1) % (1 << 63))
        self._control()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        self._call(self.pool[0])          # every shape the window sends
        self.n_steps = 0
        self.setup_phases = {"data_s": t1 - t0, "weights_s": t2 - t1,
                             "warmup_s": time.perf_counter() - t2}

    def _control(self) -> None:
        """The control's rounding of every MoE layer's output."""
        name = self.program.get("expert_dtype")
        if name is None:
            return
        from repro_torch.models import moe
        dtype, ffn = getattr(torch, name), moe._dropless_ffn

        def rounded(*a, **kw):
            y, counts = ffn(*a, **kw)
            return y.to(dtype).to(y.dtype), counts
        moe._dropless_ffn, self._restore = rounded, (moe, ffn)

    def _call(self, prompts: torch.Tensor, **kw):
        return self.generate(self.bundle, self.params, {"tokens": prompts},
                             max_new_tokens=self.traffic["new_tokens"],
                             temperature=self.traffic["temperature"], **kw)

    # -- the window ------------------------------------------------------
    def step(self) -> int:
        """One ``generate`` call on the next pool batch: prompts answered."""
        p = self.n_steps % len(self.pool)
        self.last = (p, self._call(self.pool[p]))
        self.n_steps += 1
        return len(self.pool[p])

    def step_work(self) -> dict:
        tr = self.traffic
        return {"rows": tr["batch"], "prompt_len": tr["prompt_len"],
                "new_tokens": tr["new_tokens"]}

    # -- the check -------------------------------------------------------
    def release(self) -> None:
        """Keep the weights (the reference reads them) and the window's
        last answer; free the rest."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list[tuple[str, int, int]]:
        """(name, value, limit) of every number compared; each limit is
        0."""
        ref = harness.load_module(self.bench, "references",
                                  self.cfg["reference"])
        tol = self.cfg["check"]
        p, toks = self.last
        replay, kept = self._call(self.pool[p], keep_logits=True)
        replay_differ = int((replay != toks).any(axis=1).sum())
        rng = np.random.default_rng(self.seed)
        rows = np.sort(rng.choice(len(toks), self.traffic["check_rows"],
                                  replace=False))
        dev = self.device
        s, n = self.traffic["prompt_len"], self.traffic["new_tokens"]
        chosen = torch.as_tensor(toks[rows], device=dev).long()
        seq = torch.cat([self.pool[p][torch.as_tensor(rows, device=dev)],
                         chosen[:, :-1].to(torch.int32)], dim=1)
        layer_io: list = []
        want = ref.logits(self.params, self.cfg, seq,
                          torch.arange(s - 1, s - 1 + n, device=dev),
                          layer_io)
        got = kept[torch.as_tensor(rows, device=dev)]
        err = (got - want).abs().amax(dim=(1, 2))
        gap = (want.amax(dim=-1)
               - want.gather(-1, chosen[..., None])[..., 0]).amax(dim=1)
        miss = self._layer_miss(ref, layer_io, "moe", tol["route_margin"])
        ssm_miss = self._layer_miss(ref, layer_io, "ssm")
        if self._restore is not None:      # the control ends with the check
            self._restore[0]._dropless_ffn = self._restore[1]
        self.checked = {"rows": rows.tolist(), "positions": n,
                        "logit_err": err.tolist(), "token_gap": gap.tolist(),
                        "expert_miss": miss.tolist(),
                        "ssm_miss": ssm_miss.tolist(),
                        "logit_std": float(want.std())}
        self.program_state = {"replayed_rows": len(toks)}
        return [("replay_rows_differ", replay_differ, 0),
                ("logit_rows_off", int((err > tol["logit_tol"]).sum()), 0),
                ("token_rows_off", int((gap > tol["token_tol"]).sum()), 0),
                ("expert_rows_off", int((miss > tol["expert_tol"]).sum()),
                 0),
                ("ssm_rows_off", int((ssm_miss > tol["ssm_tol"]).sum()), 0)]

    def _layer_miss(self, ref, layer_io: list, kind: str,
                    margin: float | None = None) -> torch.Tensor:
        """(rows,) the largest over the layers' ``kind`` ("moe" or "ssm")
        branches of ||program - reference|| / ||reference|| of a token's
        output, the program's ``moe_block`` or ``ssm_block`` run on the
        reference's input (in the program's dtype): for "moe" the
        largest over the tokens with a clear selection (``margin``), for
        "ssm" the 99th percentile over the row's tokens."""
        from repro_torch.models.moe import moe_block
        from repro_torch.models.ssm import ssm_block
        dtype = getattr(torch, self.model_cfg.dtype)
        miss = None
        for i, k, u, want in layer_io:
            if k != kind:
                continue
            p = self.params["layers"][i][kind]
            with torch.no_grad():
                if kind == "moe":
                    y, _ = moe_block(p, u.to(dtype), self.model_cfg)
                else:
                    y, _, _ = ssm_block(p, u.to(dtype), self.model_cfg)
            rel = (y.float() - want).norm(dim=-1) / want.norm(dim=-1)
            if kind == "moe":
                clear = ref.route_margin(p, u.reshape(-1, u.shape[-1]),
                                         self.cfg).reshape(rel.shape) \
                    >= margin
                worst = torch.where(clear, rel, 0.0).amax(dim=1)
            else:
                worst = rel.quantile(0.99, dim=1)
            miss = worst if miss is None else torch.maximum(miss, worst)
        return miss
