#!/usr/bin/env python3
"""The benchmark of ``zonos_vibes_tpu_torch``: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run is one process. It makes the cell's weights on the card from the
seed, starts the port's ``TTSServer`` in process on ``127.0.0.1`` (port 0),
warms every shape the cell's traffic uses with requests, and puts the
cell's traffic on it from a child process for ``--seconds``, after a
lead-in of the same load. It then judges what the served path produced
against the plain reference in ``perfbench/reference/`` and prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; its last
key, ``check``, holds each number compared beside its limit, which are also
the last lines of standard error.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``perfbench/configs/<config>.json``,
its traffic in ``perfbench/mixes/<traffic>.json``, and each metric's reader
in ``perfbench/metrics/<name>.py`` (a ``read(ctx)`` returning a number, or
None when it finds nothing to read).
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import wave  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "zonos_vibes_tpu")
HOP = 512  # samples per code frame at 44.1 kHz
TAIL_FRAMES = 16  # the end of a stream vocoded against zero codes past it, not compared
OUT_OF_RANGE = 1e9  # the gap read for a served code outside the codebook


def load_cell(name: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(cell_spec(name, cell["config"], cell["traffic"], cell["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def cell_spec(name: str, config: str, traffic: str, chips: int = 1) -> dict:
    """A configuration under a traffic mix, found by their names, with no
    metrics (the knee sweep runs mixes that no cell holds yet)."""
    return {"name": name, "chips": chips,
            "config": json.loads((HERE / "configs" / f"{config}.json").read_text()),
            "mix": json.loads((HERE / "mixes" / f"{traffic}.json").read_text()),
            "end_to_end": [], "per_layer": []}


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def write_wav(path: Path, pcm, sr: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run of a cell (``spec`` as :func:`load_cell` returns it)."""

    def __init__(self, spec: dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
                 control: bool = False):
        self.spec, self.seed, self.seconds, self.traced = spec, int(seed), float(seconds), traced
        self.device, self.control = device, control
        self.before_load = None  # a test's hook: plants a fault once set-up is done
        self.cfg, self.mix = spec["config"], spec["mix"]

    def say(self, msg: str) -> None:
        print(f"perfbench: {msg}", file=sys.stderr, flush=True)

    # -- the program ---------------------------------------------------------

    def build_program(self):
        import torch

        from perfbench.lib import weights as W
        from zonos_vibes_tpu_torch.config import ZonosConfig
        from zonos_vibes_tpu_torch.models.dac import DACConfig
        from zonos_vibes_tpu_torch.models.speaker import SpeakerEncoder
        from zonos_vibes_tpu_torch.pipeline import ZonosPipeline

        dev = torch.device(self.device)
        model_cfg, dac_cfg, spk_cfg = self.cfg["model"], self.cfg["dac"], self.cfg["speaker"]
        params = W.make_model(model_cfg, self.seed, dev)
        dacp = W.make_dac(dac_cfg, self.seed, dev)
        dac_kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in dac_cfg.items()}
        pipe = ZonosPipeline.from_params(ZonosConfig.from_dict(model_cfg), params,
                                         dac_params=dacp, device=dev,
                                         dac_config=DACConfig(**dac_kw))
        pipe.speaker_encoder = SpeakerEncoder(**{k: (tuple(v) if isinstance(v, list) else v)
                                                 for k, v in spk_cfg.items()})
        pipe.speaker_params = W.make_speaker(spk_cfg, self.seed, dev)
        serving = self.cfg["serving"]
        if serving["weights"] == "int8":
            pipe.quantize_int8()
        elif serving["weights"] != "bf16":
            raise ValueError(f"serving weights {serving['weights']!r}")
        return pipe

    def start_server(self, pipe):
        from zonos_vibes_tpu_torch.serve.server import TTSServer

        srv_cfg, serving = self.mix["server"], self.cfg["serving"]
        srv = TTSServer(pipe, host="127.0.0.1", port=0, request_timeout_s=600.0,
                        pooled=srv_cfg["pooled"], pool_slots=srv_cfg.get("pool_slots", 4),
                        pool_kv_int8=serving.get("pool_kv_int8", False),
                        pool_state_bf16=serving.get("pool_state_bf16", False))
        srv.start_background()
        return srv

    # -- the run -------------------------------------------------------------

    def execute(self) -> dict:
        from perfbench.lib import loadgen, traffic

        self.tmp = Path(tempfile.mkdtemp(prefix="perfbench-"))
        ctx = multiprocessing.get_context("spawn")
        conn, child_conn = ctx.Pipe()
        child = ctx.Process(target=loadgen.child_main, args=(child_conn,), daemon=True)
        child.start()
        try:
            speakers = []
            for i in range(self.mix["speakers"]):
                path = self.tmp / f"voice{i}.wav"
                write_wav(path, traffic.speaker_wav(self.seed, i), 16000)
                speakers.append(str(path))
            self._conn, self._child = conn, child
            return self._drive(speakers)
        finally:
            try:
                conn.send({"op": "quit"})
            except OSError:
                pass
            child.join(30)
            if child.is_alive():
                child.kill()
                child.join(10)
            shutil.rmtree(self.tmp, ignore_errors=True)

    def _idle(self, srv) -> None:
        """Wait until the server holds no request (the warm-up's rows are
        freed at their next segment once their clients hang up)."""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            busy = not srv.queue.empty() or any(j.rows for j in srv._pool_jobs.values())
            if not busy:
                time.sleep(0.5)
                if srv.queue.empty() and not any(j.rows for j in srv._pool_jobs.values()):
                    return
            time.sleep(0.05)

    def _call(self, cmd: dict, timeout: float = 600.0) -> dict:
        """A command to the load generator; its answer."""
        self._conn.send(cmd)
        deadline = time.monotonic() + timeout
        while not self._conn.poll(1.0):
            if not self._child.is_alive() or time.monotonic() > deadline:
                raise RuntimeError(f"the load generator gave no answer to {cmd['op']!r}")
        return self._conn.recv()

    def setup(self, speakers):
        """The program built from the seed's weights, observed, serving, and
        warmed by requests of every shape the traffic sends, through the
        pool and, where the traffic can find the pool full (an open loop,
        or more clients than slots), with the pool held full, through the
        job path that such requests take. Returns ``(pipe, observer,
        server, warm-up requests that brought audio)``."""
        from perfbench.lib import traffic
        from perfbench.lib.observe import Observer

        pipe = self.build_program()
        obs = Observer()
        obs.install(pipe)
        srv = self.start_server(pipe)
        mix, port = self.mix, srv.port
        warm = traffic.warm_payloads(mix, speakers, srv._bucket, srv._cond_bucket)
        pooled = mix["server"]["pooled"]
        slots = mix["server"]["pool_slots"] if pooled else 1
        got = self._call({"op": "warm", "port": port, "payloads": warm, "clients": slots,
                          "give_up_at": time.monotonic() + 300})["warm_ok"]
        self._idle(srv)
        overflow = pooled and (mix["loop"] == "open" or mix["clients"] > slots)
        jobs = srv.max_active_jobs - 1 if overflow else 0
        if overflow:
            frames = int(round(mix["frames_per_second"] * mix["seconds"]["max"]))
            hold = [traffic.payload(mix, "Hold.", frames, speakers[0], f"h{i}")
                    for i in range(slots)]
            self._call({"op": "hold", "port": port, "payloads": hold,
                        "give_up_at": time.monotonic() + 300})
            # As many of each shape at once as the job path runs streams: a
            # stream takes a captured step of its own shape that no other
            # running stream holds.
            for p in warm:
                got += self._call({"op": "warm", "port": port, "payloads": [p] * jobs,
                                   "clients": jobs,
                                   "give_up_at": time.monotonic() + 300})["warm_ok"]
            self._call({"op": "release"})
            self._idle(srv)
        self.say(f"warm-up: {got} of {len(warm) * (1 + jobs)} requests brought audio")
        return pipe, obs, srv, got

    def _drive(self, speakers) -> dict:
        import torch

        from perfbench.lib import trace, traffic

        pipe, obs, srv, got = self.setup(speakers)
        mix, port = self.mix, srv.port
        if self.traced and self.device == "cuda":
            trace.warm()
        if self.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        lead, grace = float(mix["lead_in_s"]), float(mix["grace_s"])
        if mix["loop"] == "open":
            n = int(float(mix["rate_per_s"]) * (lead + self.seconds) * 1.2) + 20
        else:
            n = int(mix["clients"] * (lead + self.seconds) / 0.5) + 50
        reqs = traffic.requests(mix, self.seed, n, speakers)
        load_at = time.monotonic() + 0.5
        t0 = load_at + lead
        t1 = t0 + self.seconds
        give_up = t1 + grace
        stretch = None
        if self.traced:
            stretch = trace.Stretch(t1 - 2.0 * float(mix["trace_s"]), float(mix["trace_s"]),
                                    "pool" if mix["server"]["pooled"] else "stream")
            obs.profiler = stretch
        if self.before_load is not None:
            self.before_load()
        records = self._call({"op": "run", "port": port, "requests": reqs, "loop": mix["loop"],
                              "clients": mix.get("clients", 0), "start_at": load_at,
                              "stop_at": t1, "give_up_at": give_up},
                             timeout=give_up - time.monotonic() + 120)["records"]
        if stretch is not None:
            obs.profiler = None
            stretch.finish()
            self.say(f"trace: stopping took {stretch.stop_s:.2f} s on the worker, reducing "
                     f"{stretch.reduce_s:.2f} s after the window")
        mem = torch.cuda.max_memory_allocated() if self.device == "cuda" else 0
        snap = srv.metrics.snapshot()
        srv.shutdown()
        self.say("server: " + json.dumps({k: snap[k] for k in (
            "requests_total", "errors_total", "replayed_requests", "pooled_requests",
            "pool_admitted", "pool_admit_failures")}))
        for tb in obs.failures[:3]:
            self.say("a job failed:\n" + tb)
        if stretch is not None and stretch.error:
            self.say("the profiler failed:\n" + stretch.error)
        for r in [r for r in records if r["error"]][:3]:
            self.say(f"request {r['index']}: status {r['status']}: {r['error']}")
        obs.uninstall()
        for r in records:
            r["rid"] = reqs[r["index"]]["payload"]["request_id"]
            r["frames"] = reqs[r["index"]]["frames"]
            r["speaker"] = reqs[r["index"]]["speaker"]
        ctx = SimpleNamespace(window=(t0, t1), seconds=self.seconds, records=records,
                              give_up_at=give_up, obs=obs, cfg=self.cfg, mix=mix,
                              setup_s=t0 - T_PROCESS,
                              trace=stretch.result if stretch else None,
                              stretch_span=stretch.host_span if stretch else None)
        wanted = self.spec["per_layer"] if self.traced else self.spec["end_to_end"]
        metrics = {}
        for m in wanted:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        due = [r for r in records if t0 <= r["due"] < t1]
        answered = [r for r in records if r["status"] == 200 and r["end"] is not None]
        failed_due = sum(1 for r in due if r["status"] != 200 or not r["chunks"])
        short = sum(1 for r in answered if len(r["pcm"]) != 2 * r["frames"] * HOP)
        self.say(f"{len(records)} requests sent, {len(due)} due in the window, "
                 f"{len(answered)} answered, {failed_due} of those due failed, {short} shorter "
                 f"than asked")
        sample = self._sample(records, answered, obs)
        # The program's state goes before the reference runs.
        codes = {rid: self._codes_of(obs, rid) for rid in sample}
        phon = {rid: obs.phonemes[rid][0].cpu() for rid in sample if rid in obs.phonemes}
        del pipe, srv, obs, ctx
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
        check = self.judge(records, sample, codes, phon, speakers)
        check["unanswered"] = {"value": len(records) - len(answered), "limit": 0}
        correct = all(c["value"] <= c["limit"] for c in check.values())
        device = {"platform": "gpu" if self.device == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(0) if self.device == "cuda" else "cpu",
                  "count": self.spec["chips"], "memory_peak_bytes": int(mem)}
        out = {"correct": bool(correct), "attempted": len(due), "failed": failed_due,
               "metrics": metrics, "device": device}
        if self.traced and stretch and stretch.result:
            res = stretch.result
            device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
            top = sorted(res["by_kernel"].items(), key=lambda kv: -kv[1])[:10]
            gaps = sorted(res["idle"].items(), key=lambda kv: -kv[1])[:10]
            out["breakdown"] = {"device_ops": [[k[:160], v] for k, v in top],
                                "idle_gaps": [[k, v] for k, v in gaps]}
        out["check"] = check
        return out

    # -- the check -------------------------------------------------------------

    def _codes_of(self, obs, rid):
        """The served request's codes ``[K, T]`` (on the CPU), whichever path
        served it."""
        c = obs.codes.get(rid)
        if c is None:
            return None
        K = self.cfg["model"]["num_codebooks"]
        if "delayed" in c:
            d, step = c["delayed"].cpu(), int(c["step"])
            T = step - 1 - K
            return __import__("torch").stack([d[k, k + 1: k + 1 + T] for k in range(K)])
        return c["codes"][:, : int(c["valid"])].cpu()

    def _sample(self, records, answered, obs) -> list[str]:
        """The finished requests the reference judges: the longest, then
        others drawn from the seed."""
        import numpy as np

        pool = [r for r in answered if r["rid"] in obs.codes]
        if not pool:
            return [r["rid"] for r in answered[:1]]
        pool.sort(key=lambda r: (-r["frames"], r["index"]))
        pick = [pool[0]["rid"]]
        rest = [r["rid"] for r in pool[1:]]
        rng = np.random.default_rng([self.seed % (2 ** 63), 0xC4EC])
        k = min(len(rest), int(self.mix["check"]["requests"]) - 1)
        pick += [rest[i] for i in sorted(rng.choice(len(rest), size=k, replace=False))]
        return pick

    def judge(self, records, sample, codes, phon, speakers) -> dict:
        """Each sampled request through the reference: the widest gap by
        which a served token's logit lies below the reference's best, and
        the widest difference of its streamed PCM from the reference DAC's
        (its last ``TAIL_FRAMES`` frames left out). In a control run the
        control stands in the program's place: at each position of the
        same prompt and served codes, the token that the reference one
        precision step down puts first (int4 weights for int8, fp8 e4m3
        for bf16), and the reference DAC's PCM with TF32 on, judged the
        same way."""
        import numpy as np
        import torch

        from perfbench.lib import weights as W
        from perfbench.reference import codec, zonos

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        lim = self.cfg["limits"]
        dev = torch.device(self.device)
        mcfg = self.cfg["model"]
        by_rid = {r["rid"]: r for r in records}
        gap, pcm_err, judged, missing = 0.0, 0, 0, 0
        with torch.inference_mode():
            params = W.make_model(mcfg, self.seed, dev)
            dacp = W.make_dac(self.cfg["dac"], self.seed, dev)
            spkp = W.make_speaker(self.cfg["speaker"], self.seed, dev)
            bits = 8 if self.cfg["serving"]["weights"] == "int8" else None
            ref = zonos.Reference(mcfg, params, weights=bits)
            names = {c.get("name", c["type"]) for c in mcfg["prefix_conditioner"]["conditioners"]}
            emb = {}
            samp = self.mix["sampling"]
            for rid in sample:
                rec, cd = by_rid[rid], codes.get(rid)
                if cd is None or rid not in phon:
                    missing += 1
                    continue
                if rec["speaker"] not in emb:
                    with wave.open(speakers[rec["speaker"]], "rb") as w:
                        raw = np.frombuffer(w.readframes(w.getnframes()), np.int16)
                    emb[rec["speaker"]] = codec.speaker_embedding(
                        spkp, torch.from_numpy(raw.astype(np.float32) / 32768.0).to(dev))
                values = {"espeak": phon[rid].to(dev), "speaker": emb[rec["speaker"]],
                          "speaking_rate": [15.0], "language_id": zonos.LANGUAGE_ID["en-us"]}
                if "ctc_loss" in names:
                    values["ctc_loss"] = [0.0]
                cd = cd.to(dev)
                if int(cd.min()) < 0 or int(cd.max()) >= mcfg["codebook_size"]:
                    gap = max(gap, OUT_OF_RANGE)  # a code no step could serve
                    judged += 1
                    continue
                cond = ref.conditioning(values)
                delayed = zonos.delay(cd, mcfg["masked_token_id"])
                lg = ref.logits(cond, delayed[:, : cd.shape[1]])
                pen = zonos.penalized(lg, delayed, float(samp["repetition_penalty"]),
                                      int(samp["repetition_penalty_window"]))
                frames = rec["frames"]
                want = codec.pcm16(codec.dac_decode(dacp, cd[:, :frames]))
                if self.control:
                    g, got = self._control(mcfg, params, cond, delayed, cd, pen, dacp, frames,
                                           zonos, codec, samp)
                else:
                    g, _ = zonos.widest_gap(pen, delayed)
                    got = np.frombuffer(rec["pcm"], np.int16)
                gap = max(gap, g)
                if got.size != frames * HOP:
                    pcm_err = max(pcm_err, 32767)
                else:
                    n = (frames - TAIL_FRAMES) * HOP
                    pcm_err = max(pcm_err, int(np.abs(got[:n].astype(np.int32)
                                                      - want[:n].astype(np.int32)).max()))
                judged += 1
                del lg, pen
        return {"logit_gap": {"value": gap, "limit": lim["logit_gap"]},
                "pcm_err": {"value": pcm_err, "limit": lim["pcm_err"]},
                "unjudged": {"value": missing + (0 if judged else 1), "limit": 0}}

    def _control(self, mcfg, params, cond, delayed, cd, pen, dacp, frames, zonos, codec,
                 samp):
        """The control's answer for one request: the fp32 reference's gap of
        the tokens the lower precision puts first, and the PCM of the
        reference DAC with TF32 on."""
        import torch

        low_bits = 4 if self.cfg["serving"]["weights"] == "int8" else "fp8"
        low = zonos.Reference(mcfg, params, weights=low_bits)
        lg = low.logits(cond, delayed[:, : cd.shape[1]])
        pl = zonos.penalized(lg, delayed, float(samp["repetition_penalty"]),
                             int(samp["repetition_penalty_window"]))
        gap = zonos.control_gap(pen, pl, delayed)
        del low, lg, pl
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            pcm = codec.pcm16(codec.dac_decode(dacp, cd[:, :frames]))
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        return gap, pcm


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the check's control in the program's place (it has to come "
                         "out not correct; the benchmark's own runs leave it off)")
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    # Every build and kernel cache of the program stays in the checkout.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"perfbench: the cell needs {spec['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = Run(spec, args.seed, args.seconds, bool(args.trace), control=bool(args.control)).execute()
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
