"""Batch emulation of a compiled network on ``repro_torch``'s event engine.

One batch is ``batch`` independent synthetic DVS streams: the
activity is made on the device, every stream starts from rest
(``EventEngine.init_state``), ``EventEngine.run`` steps the stream, and
the output population's spike counts and each stream's route counts come
back to the host in one wait. That wait ends the batch.

The system under test is built from the configuration's file as a user
builds it: ``compile_poker_cnn`` at the file's sizes and
``build_poker_engine`` with the file's delivery backend. The reference is
``perfbench.reference``, built from the same file; it shares nothing with
the program but the activity.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import traffic
from perfbench.reference import compare, simulate, table_v
from perfbench.reference.compare import STATE_LEAVES, Answer


@dataclasses.dataclass
class Batch:
    index: int
    enqueue_s: float  # host clock around ``EventEngine.run``, before the wait
    latency_s: float  # handed over -> answers on the host
    answer: Answer | None  # kept for the checked batches
    spikes: torch.Tensor | None  # [T, B, N], kept for traced batches


class System:
    """The program at one cell's sizes, and its reference."""

    def __init__(self, config: dict, mix: dict, cell: dict, device, batch: int | None = None):
        self.config, self.mix, self.cell = config, mix, cell
        self.device = torch.device(device)
        self.batch = int(batch or cell["batch"])
        self.steps = int(mix["steps"])
        net = config["network"]
        self.layout = table_v.layout(net)
        cs = net["cluster_size"]
        self.encoding = {
            "input_hw": net["input_hw"], "k_tags": net["k_tags"],
            "n_clusters": self.layout.n // cs,
            "input_clusters": (self.layout.conv[0] // cs, self.layout.conv[1] // cs),
            "drive": config["input"]["drive"],
        }
        self.board = config["delivery"].get("board") is not None
        self.engine = None

    # -- the program -------------------------------------------------------
    def build(self) -> None:
        from repro_torch.core.cnn import CnnConfig, compile_poker_cnn
        from repro_torch.serve.aer import build_poker_engine

        net = self.config["network"]
        fields = {f.name for f in dataclasses.fields(CnnConfig)}
        cnn = compile_poker_cnn(CnnConfig(**{k: v for k, v in net.items() if k in fields}))
        delivery = self.config["delivery"]
        options = None
        if self.board:
            options = {"link_capacity": delivery["board"]["link_capacity"]}
        self.engine = build_poker_engine(cnn, delivery["backend"], device=self.device,
                                         fabric_options=options)

    def activity(self, seed: int, index: int) -> torch.Tensor:
        return traffic.activity(self.mix, self.encoding, self.batch, seed, index, self.device)

    def run_batch(self, seed: int, index: int, keep_answer: bool = False,
                  keep_spikes: bool = False) -> Batch:
        """One batch through the program: the timed path."""
        start = time.perf_counter()
        with record_function("perfbench.inputs"):
            act = self.activity(seed, index)
            carry = self.engine.init_state(batch=self.batch)
        with record_function("perfbench.engine_run"):
            t0 = time.perf_counter()
            carry, (spikes, stats) = self.engine.run(carry, act)
            enqueue = time.perf_counter() - t0
        with record_function("perfbench.readout"):
            o0, o1 = self.layout.out
            cols = [stats.dropped.sum(0)]
            for name in simulate.ROUTE_COLUMNS[1:]:
                v = getattr(stats, name)
                cols.append(torch.zeros_like(cols[0]) if v is None else v.sum(0))
            packed = torch.cat([spikes[:, :, o0:o1].sum(0).to(torch.int32),
                                torch.stack(cols, -1).to(torch.int32)], -1).cpu()
        latency = time.perf_counter() - start
        answer = None
        if keep_answer:
            state = carry[0]
            answer = Answer(counts=packed[:, :o1 - o0], route=packed[:, o1 - o0:],
                            state={k: getattr(state, k) for k in STATE_LEAVES})
        return Batch(index, enqueue, latency, answer, spikes if keep_spikes else None)

    def warm_up(self, seed: int) -> None:
        """Every shape the window uses, at the cell's batch: one whole batch."""
        self.run_batch(seed, traffic.WARM_UP)

    def free(self) -> None:
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def shape(self) -> dict:
        """The sizes the byte and operation counts take, from the
        configuration and the reference network."""
        net = self.config["network"]
        ref = table_v.build(self.config)
        return {
            "batch": self.batch, "neurons": self.layout.n, "clusters": ref.n_clusters,
            "k_tags": net["k_tags"], "sram_entries": net["max_sram_entries"],
            "cam_words": net["max_cam_words"], "cam_words_used": table_v.cam_words(net),
            "table_entries": float(ref.entries.sum()),
            "ring_slots": len(ref.w_int) if self.board else 0,
        }

    # -- what a traced batch did ---------------------------------------------
    def event_counts(self, spikes: torch.Tensor, net: table_v.Network) -> dict[str, float]:
        """Per step of a traced batch, summed over its streams: the spikes
        each step routes (the previous step's), the SRAM entries they drive,
        and the steps counted."""
        routed = spikes[:-1].float()  # step t routes the spikes of step t - 1
        return {
            "steps": float(spikes.shape[0]),
            "events": float(routed.sum()),
            "entries": float((routed @ net.entries.to(routed.device)).sum()),
        }

    # -- the reference -------------------------------------------------------
    def reference_network(self, dtype=torch.float32) -> table_v.Network:
        return table_v.build(self.config).to(self.device, dtype)

    def reference(self, seed: int, index: int, net: table_v.Network,
                  dtype=torch.float32) -> simulate.Outcome:
        return simulate.simulate(net, self.config["neuron"], self.activity(seed, index), dtype)

    def check(self, seed: int, answers: dict[int, Answer]) -> tuple[dict[str, float], int]:
        """The comparison's numbers for ``answers`` (by batch index), and the
        checked streams whose answers differ from the reference's."""
        net = self.reference_network()
        outcomes = [self.reference(seed, i, net) for i in answers]
        return compare.numbers(list(answers.values()), outcomes, self.board)

    def reference_answers(self, seed: int, indices, dtype) -> dict[int, Answer]:
        """The reference in ``dtype`` put in the program's place: the answers
        it gives for the batches ``indices`` (the control)."""
        net = self.reference_network(dtype)
        out = {}
        for i in indices:
            o = self.reference(seed, i, net, dtype)
            out[i] = Answer(counts=o.counts.round().to(torch.int32).cpu(),
                            route=o.route.round().to(torch.int32).cpu(),
                            state={k: getattr(o.state, k).float() for k in STATE_LEAVES})
        return out


def checked_batches(seed: int, cell: dict) -> list[int]:
    """The batches whose answers are compared, drawn from the seed among
    the first ``check_within`` of the window."""
    rng = np.random.default_rng([int(seed) % 2**64, 2])
    picks = rng.choice(cell["check_within"], size=cell["check_batches"], replace=False)
    return sorted(int(i) for i in picks)
