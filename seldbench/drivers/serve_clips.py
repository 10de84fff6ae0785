"""Driver ``serve_clips``: one client in a closed loop, clip by clip, as
``cli infer`` serves a wav folder: the port's eval loader over the mix's
clips held in memory (:func:`seldbench.program.eval_loader`), the eval
forward and the decode, without the CSV.  Each request runs from the
clip's int16 samples on the host, at its true length, to its detections
on the host; the loader's normalisation and padding are in it.  The
mix's clip lengths are cycled in their order, one pass of the loader a
cycle; every seed draws the same lengths and event counts.

Set-up renders one cycle of clips and sets the decode's tau from the
reference's class confidences over every whole clip of the cycle, so that
the cell's ``candidates_a_frame`` of them a label frame clear it over the
cycle whatever the seed, and the host decode has about as much to do on
every seed (random weights light a seed's anchors on nearly every frame
or on none at a fixed tau).  It then builds the eval forward, the loader and the
decode at that tau, and serves ``warm_cycles`` cycles, which warm every
bucket the cycle uses.  Window: clips until ``--seconds`` have passed;
``serve_audio_s`` is the audio-seconds of the clips finished over the
window, ``clip_p95_ms`` the 95th percentile of their latencies.  Traced:
after the window, each from a cycle's start, one cycle with each clip's
decode timed after a synchronise, one profiled on the device alone and
one with the host's ops.  Check: a sample of the window's clips, drawn
from the seed with the longest always in it, against the reference
forward at each clip's own length and the reference decode of the
program's logits; a sample whose reference decode finds no detection
fails, since it would not test the decode.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from .. import checks, program
from ..reference.decode import (class_confidence, compare_detections, decode_clip,
                                threshold_at_rate)
from ..yardstick import profile
from ..yardstick.traffic import clip_stream, sub_seed
from .base import DriverBase

__all__ = ["Driver"]


def logit_gap(program_logits: torch.Tensor, ref: torch.Tensor) -> float:
    """``max |logits_p - logits_r| / max |logits_r|`` over the clip's frames."""
    return float((program_logits[:len(ref)] - ref).abs().max() / ref.abs().max())


class Driver(DriverBase):
    def setup(self):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        cell, d = self.cell, self.config["data"]
        self.ref = self.reference_model().eval()
        self.cfg = program.port_config(self.config, cell)
        self.clips = clip_stream(self.mix, self.config, self.seed, self.device)
        self.frames = [c["secs"] * d["sr"] // d["hop_length"] for c in self.clips]
        self.flops = [self.model_flops(t, 1, backward=False) for t in self.frames]
        n = len(self.clips)
        rng = np.random.default_rng(sub_seed(self.seed, 6))
        longest = int(np.argmax(self.frames))
        others = [i for i in range(n) if i != longest]
        pick = rng.choice(len(others), size=min(int(cell["check_sample"]) - 1, len(others)),
                          replace=False)
        self.sample = sorted({longest, *(others[i] for i in pick)})
        self.tau = self.threshold()
        self.build_program()
        for _ in range(int(cell["warm_cycles"])):
            self.serve_cycle()

    def label_frames(self, k: int) -> int:
        return self.clips[k]["secs"] * 10

    def threshold(self) -> float:
        """tau from the reference over every whole clip of the cycle, one
        clip at a time at its own length; the device's memory peak is
        reset after it."""
        conf, frames = [], 0
        for k in range(len(self.clips)):
            conf.append(class_confidence(self.reference_logits(k), self.label_frames(k),
                                         self.grid, self.config["data"]["nb_classes"]))
            frames += self.label_frames(k)
        tau = threshold_at_rate(torch.cat(conf), frames,
                                float(self.cell["candidates_a_frame"]))
        del conf
        self.free()
        if self.device.type == "cuda":  # the peak to report is the program's
            torch.cuda.reset_peak_memory_stats(self.device)
        return tau

    def build_program(self):
        model = program.build_model(self.cfg, self.ref.state_dict(), self.device, train=False)
        fe = program.frontend(self.config, self.cfg, self.device)
        self.fwd = program.eval_forward(model, fe)
        self.pp = program.postprocessor(self.cfg, self.tau)
        self.index = {f"clip{k:02d}": k for k in range(len(self.clips))}
        self.loader = program.eval_loader(
            self.cfg, [(name, self.clips[k]["audio"]) for name, k in self.index.items()])
        self.items = iter(())
        self.reset()

    def reset(self):
        self.lat, self.done, self.kept = [], [], {}
        self.decode_s, self.decoded = 0.0, 0

    def _serve(self, timed_decode=False):
        t0 = time.perf_counter()
        with profile.span("load"):
            item = next(self.items, None)
            if item is None:  # the loader's next pass over the clips
                self.items = iter(self.loader)
                item = next(self.items)
        with profile.span("forward"):
            logits = self.fwd(item["audio"], item["valid_feat_frames"])
        if timed_decode:
            torch.cuda.synchronize()
            td = time.perf_counter()
        with profile.span("decode"):
            dets = self.pp.postprocess(logits, valid_label_frames=item["nb_label_frames"])
        if timed_decode:
            self.decode_s += time.perf_counter() - td
            self.decoded += 1
        self.lat.append(time.perf_counter() - t0)
        k = self.index[item["name"]]
        self.done.append(k)
        if k in self.sample and k not in self.kept:
            self.kept[k] = (logits, dets)

    def serve_cycle(self, timed_decode=False):
        """One pass of the loader over the clips, from its start."""
        self.items = iter(self.loader)
        for _ in self.clips:
            self._serve(timed_decode)

    def window(self, seconds: float) -> dict:
        self.reset()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            self._serve()
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        n_done, lat = len(self.done), list(self.lat)
        secs = [self.clips[k]["secs"] for k in self.done]
        by_clip = {}
        for k, t in zip(self.done, lat):
            by_clip.setdefault(k, []).append(t)
        res = {"seconds": wall, "clips": n_done,
               "call_s": sum(statistics.median(v) for v in by_clip.values()) / len(by_clip),
               "flops": float(sum(self.flops[k] for k in self.done)),
               "e2e": {"serve_audio_s": sum(secs) / wall,
                       "clip_p95_ms": 1e3 * statistics.quantiles(lat, n=20)[18]},
               "profile": None, "decode_ms": None}
        if self.trace and cuda:  # after the window, each from the cycle's start
            n = len(self.clips)
            self.serve_cycle(timed_decode=True)
            res["decode_ms"] = 1e3 * self.decode_s / self.decoded
            self.items = iter(self.loader)
            res["profile"] = profile.profile_calls(lambda i: self._serve(), n,
                                                   program.kernel_counters)
            self.items = iter(self.loader)
            res["ops"] = profile.profile_calls(lambda i: self._serve(), n,
                                               program.kernel_counters, cpu=True)
            m = self.config["model"]
            res["attention"] = {"calls": m["conformer_blocks"], "heads": m["heads"],
                                "q": self.frames, "k": self.frames, "backward": False,
                                "steps": n} if "conformer_blocks" in m else None
        res.update(attempted=len(self.done), failed=0)
        return res

    def reference_logits(self, k: int, tf32: bool = False) -> torch.Tensor:
        c = self.clips[k]
        fe = self.reference_frontend()
        with torch.no_grad(), checks.lower_precision(tf32):
            return self.ref(fe(c["audio"][None]), q_block=int(self.cell["ref_query_block"]))[0]

    def check(self) -> dict:
        """The program's numbers over the kept clips; frees the program."""
        kept = dict(self.kept)
        del self.fwd, self.pp, self.loader, self.items
        self.free()
        gap, mismatch, dets_n, ref_n, events, frames_n = 0.0, 0, 0, 0, 0, 0
        cand, lit, full = 0, 0, 0
        d, tr = self.config["data"], self.config["train"]
        for k, (logits, dets) in sorted(kept.items()):
            frames = self.label_frames(k)
            hot = torch.sigmoid(logits[0][:frames].reshape(frames, -1, d["nb_classes"] + 3)
                                [..., 0]) > self.tau
            per_frame = hot.sum(-1)
            cand += int(per_frame.sum())
            lit += int((per_frame > 0).sum())
            full += int((per_frame >= int(tr["decode_topk"])).sum())
            ref_dets = decode_clip(logits[0], frames, self.grid, d["nb_classes"], self.tau,
                                   tr["unify_thresh"])
            mismatch += compare_detections(dets, ref_dets)
            clip_gap = logit_gap(logits[0], self.reference_logits(k))
            gap = max(gap, clip_gap)
            dets_n += sum(len(v) for v in dets.values())
            ref_n += sum(len(v) for v in ref_dets.values())
            events += self.clips[k]["events"]
            frames_n += frames
            self.note(f"clip {k} ({self.clips[k]['secs']} s): logit gap {clip_gap!r}, "
                      f"detections {sum(len(v) for v in dets.values())}")
        self.note(f"tau {self.tau!r}: detections a label frame {dets_n / max(frames_n, 1)!r}, "
                  f"rendered events a label frame {events / max(frames_n, 1)!r} "
                  f"(sampled clips)")
        self.note(f"decode work: anchors over tau a label frame {cand / max(frames_n, 1)!r}, "
                  f"label frames with one {lit / max(frames_n, 1)!r}, with decode_topk or more "
                  f"{full / max(frames_n, 1)!r} (sampled clips)")
        lim = self.cell["limits"]
        missing = [k for k in self.sample if k not in kept]
        if missing:
            self.note(f"sampled clips {missing} were never finished in the window")
            mismatch += len(missing)
        return {"logit_gap": (gap, float(lim["logit_gap"])),
                "det_mismatch": (float(mismatch), float(lim["det_mismatch"])),
                "no_detection": (float(ref_n == 0), float(lim["no_detection"]))}
