"""Prefill of a language model on ``repro_torch``'s normal serving path.

One batch is ``batch`` prompts of ``prompt_len`` token ids, drawn uniformly
over the vocabulary on the device from (seed, batch). Each batch prefills
into a fresh latent cache (``Model.init_caches``), ``Model.prefill(...,
return_aux=True)`` runs the whole model, and the last position's logits
``[batch, vocab]`` float32 and the MoE counters (each layer's assignments
per expert and assignments dropped) come back to the host in one wait,
which ends the batch. A stream is a prompt and a step one of its tokens,
so the harness's ``stream_steps_per_s`` reads prompt tokens a second and
``batch_latency_ms_p90`` the hand-over to logits.

The system under test is built as a user builds it: ``get_config(arch)``
(the configuration file's numbers must equal the program's) and
``build_model(cfg, device)``; the weights of ``--seed`` are then loaded by
name from ``reference/deepseek_v2_lite.py``'s maker through
``checkpoint.hf.load_deepseek_v2``, as a checkpoint load would. The
reference makes the same tensors again and shares nothing else with the
program but the token ids.

A traced batch's work (:meth:`System.event_counts`) comes from running it
once more under the profiler: the device seconds launched inside the
program's spans ``repro_torch.mla``, ``repro_torch.moe.dispatch`` and
``repro_torch.moe.experts`` (``perfbench/spans.py``), and its MoE counters.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import spans, traffic
from perfbench.reference import deepseek_v2_lite as reference
from perfbench.reference.compare_lm import LmAnswer, numbers

# the published keys the program's configuration must match, and the program's
# reading of each (``get_config(arch)``)
PUBLISHED = {
    "hidden_size": lambda c: c.d_model,
    "num_attention_heads": lambda c: c.n_heads,
    "num_key_value_heads": lambda c: c.n_kv_heads,
    "intermediate_size": lambda c: c.d_ff,
    "moe_intermediate_size": lambda c: c.moe_d_ff,
    "vocab_size": lambda c: c.vocab,
    "num_hidden_layers": lambda c: c.n_layers,
    "first_k_dense_replace": lambda c: len(c.prefix_layers),
    "n_routed_experts": lambda c: c.n_experts,
    "n_shared_experts": lambda c: c.n_shared_experts,
    "num_experts_per_tok": lambda c: c.top_k,
    "q_lora_rank": lambda c: c.q_lora_rank or None,
    "kv_lora_rank": lambda c: c.kv_lora_rank,
    "qk_nope_head_dim": lambda c: c.qk_nope_dim,
    "qk_rope_head_dim": lambda c: c.qk_rope_dim,
    "v_head_dim": lambda c: c.v_head_dim,
    "rope_theta": lambda c: c.rope_theta,
    "rms_norm_eps": lambda c: c.norm_eps,
    "norm_topk_prob": lambda c: c.norm_topk_prob,
    "routed_scaling_factor": lambda c: c.routed_scaling_factor,
    "tie_word_embeddings": lambda c: c.tie_embeddings,
    "scoring_func": lambda c: "sigmoid" if c.router_aux_free else "softmax",
    "rope_scaling": lambda c: {
        "type": "yarn", "factor": c.yarn.factor,
        "original_max_position_embeddings": c.yarn.original_max_position,
        "beta_fast": c.yarn.beta_fast, "beta_slow": c.yarn.beta_slow, "mscale": c.yarn.mscale,
        "mscale_all_dim": c.yarn.mscale_all_dim},
}


def published(cfg) -> dict:
    """The program's configuration ``cfg`` under the published keys."""
    return {key: read(cfg) for key, read in PUBLISHED.items()}


@dataclasses.dataclass
class Batch:
    index: int
    enqueue_s: float  # host clock around ``Model.prefill``, before the wait
    latency_s: float  # handed over -> logits and counters on the host
    answer: LmAnswer | None  # kept for the checked batches
    spikes: dict | None  # for traced batches: what :meth:`System.event_counts` reruns


class System:
    """The program at one cell's sizes, and its reference."""

    def __init__(self, config: dict, mix: dict, cell: dict, device, batch: int | None = None):
        self.config, self.mix, self.cell = config, mix, cell
        self.device = torch.device(device)
        self.batch = int(batch or cell["batch"])
        self.steps = int(mix["prompt_len"])
        self.model = None
        self.seed = None  # whose weights the model holds

    # -- the program -------------------------------------------------------
    def build(self) -> None:
        from repro_torch.configs import get_config
        from repro_torch.models.model import build_model

        cfg = get_config(self.config["arch"], smoke=self.config.get("smoke", False))
        ours = published(cfg)
        wrong = {k: (self.config[k], v) for k, v in ours.items() if self.config[k] != v}
        if wrong:
            raise ValueError(f"{cfg.name}: the program's configuration differs from the "
                             f"file's (file, program): {wrong}")
        self.model = build_model(cfg, self.device)
        self.seed = None

    def _weights(self, seed: int) -> None:
        """The model of ``seed``: every published tensor made by name and
        loaded, once per seed."""
        from repro_torch.checkpoint.hf import load_deepseek_v2

        if self.seed != seed:
            load_deepseek_v2(self.model,
                             lambda name, shape: reference.make(seed, name, shape, self.device))
            self.seed = seed

    def tokens(self, seed: int, index: int) -> torch.Tensor:
        gen = traffic.generator(seed, index, self.device)
        return torch.randint(self.config["vocab_size"], (self.batch, self.steps), generator=gen,
                             device=self.device)

    def run_batch(self, seed: int, index: int, keep_answer: bool = False,
                  keep_spikes: bool = False) -> Batch:
        """One batch through the program: the timed path."""
        self._weights(seed)
        start = time.perf_counter()
        with torch.inference_mode():
            with record_function("perfbench.inputs"):
                tokens = self.tokens(seed, index)
                caches = self.model.init_caches(self.batch, self.steps)
            with record_function("perfbench.prefill"):
                t0 = time.perf_counter()
                logits, caches, aux = self.model.prefill(tokens, caches, return_aux=True)
                enqueue = time.perf_counter() - t0
            with record_function("perfbench.readout"):
                # a period of DeepSeek-V2-Lite is one MoE layer
                load, dropped = aux["moe_load_periods"], aux["moe_dropped"]
                packed = torch.cat([logits.reshape(-1), load.reshape(-1), dropped]).cpu()
        latency = time.perf_counter() - start
        n_logits, n_load = logits.numel(), load.numel()
        host_load = packed[n_logits:n_logits + n_load].view(load.shape)
        host_dropped = packed[n_logits + n_load:]
        answer = None
        if keep_answer:
            last = caches["stack"][-1]
            answer = LmAnswer(logits=packed[:n_logits].view(self.batch, -1), load=host_load,
                              dropped=host_dropped, choices=aux["moe_choices"],
                              c_kv=last["c_kv"], k_rope=last["k_rope"])
        kept = None
        if keep_spikes:
            kept = {"seed": seed, "index": index, "load": host_load, "dropped": host_dropped}
        return Batch(index, enqueue, latency, answer, kept)

    def warm_up(self, seed: int) -> None:
        """The weights of ``seed`` and every shape the window uses: one
        whole batch."""
        self.run_batch(seed, traffic.WARM_UP)

    def free(self) -> None:
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def shape(self) -> dict:
        """The sizes the byte and operation counts take, from the
        configuration file's published numbers."""
        c = self.config
        dense = c["first_k_dense_replace"]
        return {
            "batch": self.batch, "prompt_len": self.steps, "d_model": c["hidden_size"],
            "n_heads": c["num_attention_heads"], "qk_nope_dim": c["qk_nope_head_dim"],
            "qk_rope_dim": c["qk_rope_head_dim"], "v_head_dim": c["v_head_dim"],
            "kv_lora": c["kv_lora_rank"], "d_ff": c["intermediate_size"],
            "moe_d_ff": c["moe_intermediate_size"], "n_experts": c["n_routed_experts"],
            "top_k": c["num_experts_per_tok"], "n_shared": c["n_shared_experts"],
            "layers": c["num_hidden_layers"], "dense_layers": dense,
            "moe_layers": c["num_hidden_layers"] - dense, "vocab": c["vocab_size"],
        }

    # -- what a traced batch did ---------------------------------------------
    def event_counts(self, kept: dict, net=None) -> dict[str, float]:
        """A traced batch's work: the batch run again under the profiler
        (after one that warms it up), the device seconds launched inside the
        latent attention, the MoE dispatch and the routed experts, and its
        MoE counters. Summed over the traced batches by the harness."""
        traced = spans.profiled(self, kept["seed"], kept["index"] - 1, 1)
        got = spans.read(traced["events"], traced["w0"], traced["w1"])

        def device_s(name):
            return got.get(name, {"device_s": 0.0})["device_s"]

        load = kept["load"].double()
        return {
            "prefills": 1.0,
            "tokens": float(self.batch * self.steps),
            "mla_s": device_s("repro_torch.mla"),
            "moe_dispatch_s": device_s("repro_torch.moe.dispatch"),
            "expert_ffn_s": device_s("repro_torch.moe.experts"),
            "expert_rows": float(load.sum()),
            "load_max_over_mean": float((load.amax(1) / load.mean(1)).mean()),
            "dropped": float(kept["dropped"].sum()),
        }

    # -- the reference -------------------------------------------------------
    def reference_network(self, dtype=torch.float32):
        """Nothing to build ahead: the reference makes its weights layer by
        layer."""
        return None

    def _reference(self, seed: int, indices, dtype=torch.float32, round_to=None) -> list[dict]:
        """The reference's outputs for the batches ``indices``, all prompts
        in one pass (each layer's weights made once)."""
        tokens = torch.cat([self.tokens(seed, i) for i in indices])
        out = reference.forward(self.config, seed, tokens, dtype=dtype, round_to=round_to)
        per = self.batch * self.steps
        return [{"logits": out["logits"][j * self.batch:(j + 1) * self.batch],
                 "choices": out["choices"][:, j * per:(j + 1) * per],
                 "c_kv": out["c_kv"][j * self.batch:(j + 1) * self.batch],
                 "k_rope": out["k_rope"][j * self.batch:(j + 1) * self.batch]}
                for j in range(len(indices))]

    def check(self, seed: int, answers: dict[int, LmAnswer]) -> tuple[dict[str, float], int]:
        """The comparison's numbers for ``answers`` (by batch index), and the
        checked prompts that failed outright."""
        return numbers(list(answers.values()), self._reference(seed, list(answers)))

    def reference_answers(self, seed: int, indices, dtype) -> dict[int, LmAnswer]:
        """The reference put in the program's place for the batches
        ``indices``: in float64 for ``torch.float64``, else in float32 with
        every matrix product's inputs rounded to ``dtype`` (the controls)."""
        wide = dtype == torch.float64
        refs = self._reference(seed, indices, torch.float64 if wide else torch.float32,
                               None if wide or dtype == torch.float32 else dtype)
        out = {}
        n_moe = self.config["num_hidden_layers"] - self.config["first_k_dense_replace"]
        for i, r in zip(indices, refs):
            load = torch.stack([torch.bincount(c.reshape(-1), minlength=self.config[
                "n_routed_experts"]) for c in r["choices"]]).float().cpu()
            out[i] = LmAnswer(logits=r["logits"].float().cpu(), load=load,
                              dropped=torch.zeros(n_moe), choices=r["choices"],
                              c_kv=r["c_kv"].float(), k_rope=r["k_rope"].float())
        return out


def checked_batches(seed: int, cell: dict) -> list[int]:
    """The batches whose answers are compared, drawn from the seed among
    the first ``check_within`` of the window."""
    rng = np.random.default_rng([int(seed) % 2**64, 2])
    picks = rng.choice(cell["check_within"], size=cell["check_batches"], replace=False)
    return sorted(int(i) for i in picks)
