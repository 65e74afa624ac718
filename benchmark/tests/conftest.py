"""Shared helpers of the benchmark's own tests (CPU, small sizes)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_config(model: str, n: int, T: int = 4, CS: int = 4) -> dict:
    from pluss_torch.models import REGISTRY
    from pluss_torch.spec_codec import spec_to_json
    return {"name": f"{model}-{n}", "source": "test", "model": model, "n": n,
            "thread_num": T, "chunk_size": CS, "ds": 8, "cls": 64,
            "cache_kb": 2560, "reduced": [],
            "spec": spec_to_json(REGISTRY[model](n))}


def tiny_trace_config(n: int = 60) -> dict:
    """``mvt-4000-trace`` at a test's size: mvt at ``n`` (28,800 refs at
    60), its other numbers the configuration's; the batches shrink to
    match (:func:`small_batches`)."""
    from pluss_torch.models import REGISTRY
    from pluss_torch.spec_codec import spec_to_json
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "mvt-4000-trace.json")) as f:
        conf = json.load(f)
    conf.update(name=f"mvt-{n}-trace", n=n,
                spec=spec_to_json(REGISTRY[conf["model"]](n)),
                refs=8 * n * n)
    return conf


#: each serve-pool tenant's size in the tests (the inline GEMM at the
#: serve soak's host size)
TINY_SERVE_N = {"gemm-1024": 16, "mvt-4000": 16, "syrk-1024": 16,
                "inline-gemm-1024": 13}


def tiny_serve_config() -> dict:
    """``serve-pool`` with each tenant at :data:`TINY_SERVE_N`, its
    schedule and every other number the configuration's."""
    from pluss_torch.models import REGISTRY
    from pluss_torch.spec import loop_size
    from pluss_torch.spec_codec import spec_to_json
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "serve-pool.json")) as f:
        conf = json.load(f)
    conf["name"] = "serve-tiny"
    for t in conf["tenants"]:
        n = TINY_SERVE_N[t["name"]]
        spec = REGISTRY[t["model"]](n)
        doc = spec_to_json(spec)
        if "spec" in t["request"]:
            doc["name"] = f"tenant_gemm{n}"
            t["request"]["spec"] = doc
        else:
            t["request"]["n"] = n
        t.update(n=n, spec=doc,
                 accesses=sum(loop_size(x) for x in spec.nests))
    return conf


@pytest.fixture
def small_batches(monkeypatch):
    """The port's default replay geometry at :func:`tiny_trace_config`'s:
    windows of 2^10 refs, 4 to a batch."""
    from pluss_torch import residency, trace
    monkeypatch.setattr(trace, "TRACE_WINDOW", 1 << 10)
    monkeypatch.setattr(trace, "WINDOWS_PER_BATCH", 4)
    monkeypatch.delenv("PLUSS_BATCH_WINDOWS", raising=False)
    residency.store().clear()
    yield
    residency.store().clear()


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-shaped directory holding the benchmark's traffic and
    metric files and a BENCHMARK.json over tiny configurations, which a
    test extends."""
    root = tmp_path / "root"
    bench = root / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark", "traffic"),
                    bench / "traffic")
    shutil.copytree(os.path.join(ROOT, "benchmark", "metrics"),
                    bench / "metrics")
    (bench / "configs").mkdir()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    doc["configs"], doc["workloads"] = [], []

    class Root:
        path = str(root)

        def add(self, config: dict, traffic: str, mix: dict | None = None):
            name = config["name"]
            with open(bench / "configs" / f"{name}.json", "w") as f:
                json.dump(config, f)
            if mix is not None:
                with open(bench / "traffic" / f"{traffic}.json", "w") as f:
                    json.dump(mix, f)
            if name not in [c["name"] for c in doc["configs"]]:
                doc["configs"].append({
                    "name": name, "source": "test", "reduced": [],
                    "file": f"benchmark/configs/{name}.json"})
            cell = f"{name}.{traffic}"
            doc["workloads"].append({"name": cell, "config": name,
                                     "traffic": traffic, "chips": 1,
                                     "why": "test"})
            for m in doc["end_to_end"] + doc["per_layer"]:
                if "workloads" in m:
                    m["workloads"].append(cell)
            self.save()
            return cell

        def save(self):
            with open(root / "BENCHMARK.json", "w") as f:
                json.dump(doc, f)

        doc_ = doc

    r = Root()
    r.doc = doc
    return r
