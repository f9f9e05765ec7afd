"""Port parity, the serving entry point (``repro_torch.launch.serve``):
``ServeConfig`` keeps the reference's fields and adds ``device`` and
``reduced``, built from flags or TOML as the reference's is; ``run``
serves the synthetic workload in process on the CPU, a family without a
paged path on one dense-cache engine; no CUDA device raises. ``--workers 2`` (spawned
engine servers) and ``--http`` are tier 2 (``pytest.mark.slow``)."""
import dataclasses
import json
import socket
import threading
import time

import pytest
import torch

from repro.launch.serve import ServeConfig as JaxServeConfig
from repro_torch.launch.serve import ServeConfig, run


def test_config_fields_are_the_reference_and_device_reduced():
    names = [f.name for f in dataclasses.fields(ServeConfig)]
    ref = [f.name for f in dataclasses.fields(JaxServeConfig)]
    assert names == ref + ["device", "reduced"]
    d = ServeConfig()
    assert d.device == "cuda" and d.reduced is True
    for f in ref:
        assert getattr(d, f) == getattr(JaxServeConfig(), f)


def test_from_args_and_toml(tmp_path):
    c = ServeConfig.from_args(["--device", "cpu", "--no-reduced",
                               "--workers", "2", "--scheduler", "slo"])
    assert (c.device, c.reduced, c.workers, c.scheduler) == (
        "cpu", False, 2, "slo")
    path = tmp_path / "serve.toml"
    path.write_text('[serve]\ndevice = "cpu"\nreduced = false\n'
                    'requests = 3\n')
    c = ServeConfig.from_args(["--config", str(path), "--reduced"])
    assert (c.device, c.reduced, c.requests) == ("cpu", True, 3)
    path.write_text('devcie = "cpu"\n')
    with pytest.raises(ValueError, match="devcie"):
        ServeConfig.from_toml(str(path))
    with pytest.raises(ValueError, match="scheduler"):
        ServeConfig(scheduler="nope").validate()


def test_run_in_process_on_cpu(capsys):
    """Two in-process instances on the CPU serve the synthetic workload,
    drain the last instance, and drop nothing."""
    assert run(ServeConfig(device="cpu", instances=2, requests=4,
                           rps=4.0, max_new=6, drain=True)) == 4
    out = capsys.readouterr().out
    assert "[serve] cache_kind=paged device=cpu reduced float32" in out
    assert "instances=2 dropped=0" in out


def test_run_refuses_without_a_card_and_dense_families(monkeypatch, capsys):
    """A dense family is served on the CPU by one dense-cache engine;
    without a card ``run`` refuses."""
    assert run(ServeConfig(device="cpu", cache="dense", requests=2,
                           max_new=4)) == 2
    assert "[serve] cache_kind=dense device=cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run(ServeConfig(requests=1))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_run_serves_ssm_and_hybrid_on_the_dense_cache(arch, capsys):
    """``--cache auto`` picks the dense cache for the SSM and the hybrid,
    and every request finishes with its tokens."""
    assert run(ServeConfig(device="cpu", arch=arch, cache="auto",
                           requests=3, max_new=5)) == 3
    out = capsys.readouterr().out
    assert "[serve] cache_kind=dense device=cpu reduced float32" in out
    assert "[serve] 3 requests, 15 tokens" in out


@pytest.mark.parametrize("arch", ["minicpm3-4b", "whisper-medium"])
def test_run_serves_mla_and_audio_on_the_dense_cache(arch, capsys):
    """``--cache auto`` picks the dense cache for MLA and the audio
    encoder-decoder (whisper over the engine's default zero frames, as
    the reference serves it), and every request finishes."""
    assert run(ServeConfig(device="cpu", arch=arch, cache="auto",
                           requests=3, max_new=5)) == 3
    out = capsys.readouterr().out
    assert "[serve] cache_kind=dense device=cpu reduced float32" in out
    assert "[serve] 3 requests, 15 tokens" in out


# ----------------------------------------------------------- tier 2
@pytest.mark.slow
def test_run_workers_spawns_engine_servers(capsys):
    assert run(ServeConfig(device="cpu", workers=2, requests=4, rps=4.0,
                           max_new=6, drain=True)) == 4
    out = capsys.readouterr().out
    assert "distributed plane: 2 engine-server processes" in out
    assert "dropped=0" in out


@pytest.mark.slow
def test_run_http_serves_a_completion(monkeypatch):
    """``--http``: the ingress started by ``run`` answers a completion
    while it serves."""
    from repro_torch.serving import ingress as ING

    started = []
    orig = ING.Ingress.start

    def start(self):
        started.append(orig(self))
        return started[-1]

    monkeypatch.setattr(ING.Ingress, "start", start)
    reply = {}

    def client():
        deadline = time.monotonic() + 60
        while not started and time.monotonic() < deadline:
            time.sleep(0.01)
        body = json.dumps({"prompt": [5, 6, 7], "max_tokens": 4}).encode()
        with socket.create_connection(("127.0.0.1", started[0].port),
                                      timeout=60) as s:
            s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Length: %d\r\n\r\n" % len(body) + body)
            data = b""
            while chunk := s.recv(65536):
                data += chunk
        reply["body"] = json.loads(data.partition(b"\r\n\r\n")[2])

    th = threading.Thread(target=client, daemon=True)
    th.start()
    assert run(ServeConfig(device="cpu", http=True, http_port=0,
                           http_seconds=4.0)) == 1
    th.join(timeout=30)
    assert len(reply["body"]["tokens"]) == 4
