"""The port's HTTP serving endpoint against the JAX package's, on the CPU.

The cases of ``tests/test_serving_server.py:85-148`` for the chain and
``plain`` modes: ``/generate`` equal to the decoder's output (and to JAX's
server on the same weights), ``/health`` with JAX's fields, the error
reporting, and 400 naming ``ROADMAP.md`` Queue 1 item 8 for tree and batch
requests. The same for the DFlash-family block decoder (a Domino draft):
``/health`` with ``block_size``, ``/generate`` in block and ``plain``
mode. Then ``scripts/gates/serving_gate.py`` with the port alone: a tiny
``cli train``, ``cli export --to sglang``, ``serving_server_main`` in a
subprocess, and ``/generate`` equal to greedy decoding and to the JAX
decoder on the same export; and ``serving_server_main --family dflash``
in a subprocess on a port export of a Domino draft, equal to the
in-process decoder and to JAX's decoder on the same export."""

import http.client
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.inference import serving_loaders as jax_loaders
from specforge_tpu.inference import spec_decode as jax_sd
from specforge_tpu.inference.serving_server import (
    SpecServingServer as JaxServer,
)
from specforge_tpu.models.draft.dflash import DFlashConfig as JaxDFlashConfig
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.inference import (
    serving_loaders,
    serving_server_main,
    spec_decode,
)
from specforge_tpu_torch.inference.serving_server import SpecServingServer
from tests.test_torch_serving import (  # noqa: F401 (random_draft: a fixture)
    V,
    both_targets,
    jax_exported_draft,
    random_draft,
    save_llama,
    train_and_export,
)
from tests.test_torch_serving_dflash import (
    JAX_CLASSES,
    both_exports,
    draft_config,
    jax_init,
    port_draft,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
#: seconds the served subprocess may take to print READY, and to stop
READY_TIMEOUT, STOP_TIMEOUT = 120, 30


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def servers(tmp_path_factory, random_draft):
    """The port's server and JAX's over the same 4-layer target and random
    draft (tests/test_serving_server.py:29-61): k = 2, max_len 128."""
    jparams, jcfg, pparams, pcfg = both_targets(
        save_llama(tmp_path_factory.mktemp("target"), layers=4))
    module, variables, draft = random_draft
    jdec = jax_sd.Eagle3SpecDecoder(jparams, jcfg, module, variables,
                                    capture_layers=(1, 2, 3),
                                    num_draft_tokens=2, max_len=128)
    pdec = spec_decode.Eagle3SpecDecoder(pparams, pcfg, draft,
                                         capture_layers=(1, 2, 3),
                                         num_draft_tokens=2, max_len=128,
                                         device="cpu")
    mine, ref = SpecServingServer(pdec, port=0), JaxServer(jdec, port=0)
    mine.start()
    ref.start()
    yield mine, ref, pdec
    mine.stop()
    ref.stop()


def _request(port, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _post(port, path, body):
    return _request(port, "POST", path, body)


@pytest.mark.parametrize("plain", [False, True])
def test_generate_matches_decoder_and_jax(servers, plain):
    """``/generate`` in chain and plain mode: the decoder's tokens (and
    accept lengths), JAX's server's answer on the same weights, and the
    same output in both modes (the greedy invariant)."""
    mine, ref, decoder = servers
    prompt = np.random.default_rng(0).integers(0, V, size=10).tolist()
    body = {"input_ids": prompt, "max_new_tokens": 12}
    if plain:
        body["plain"] = True
    status, got = _post(mine.port, "/generate", body)
    assert status == 200
    _, want = _post(ref.port, "/generate", body)
    assert set(got) == set(want)
    for key in ("output_ids", "new_tokens", "accept_lengths",
                "mean_accept_length", "rounds"):
        assert got.get(key) == want.get(key), key
    spec = decoder.generate_fused(prompt, max_new_tokens=12)
    if plain:
        assert "accept_lengths" not in got
        np.testing.assert_array_equal(got["output_ids"][:len(spec.output_ids)],
                                      spec.output_ids[:len(got["output_ids"])])
    else:
        np.testing.assert_array_equal(got["output_ids"], spec.output_ids)
        assert got["accept_lengths"] == spec.accept_lengths
        assert got["rounds"] == spec.steps
        assert got["new_tokens"] == len(spec.output_ids) - len(prompt)


def test_health_matches_jax(servers):
    """``/health``: JAX's fields, the decoder's config, counters that grow
    with the requests served."""
    mine, ref, _ = servers
    prompt = list(range(3, 12))
    for port in (mine.port, ref.port):
        assert _post(port, "/generate", {"input_ids": prompt,
                                         "max_new_tokens": 6})[0] == 200
    (s1, got), (s2, want) = (_request(mine.port, "GET", "/health"),
                             _request(ref.port, "GET", "/health"))
    assert s1 == s2 == 200
    assert set(got) == set(want)
    assert set(got["counters"]) == set(want["counters"])
    for key in ("status", "family", "max_len", "num_draft_tokens"):
        assert got[key] == want[key], key
    assert got["family"] == "Eagle3SpecDecoder"
    assert got["counters"]["requests"] >= 1
    assert got["counters"]["output_tokens"] > 0
    assert got["counters"]["output_throughput"] > 0


@pytest.mark.parametrize("path,body,status,match", [
    ("/generate", {"max_new_tokens": 4}, 400, None),
    ("/nope", {}, 404, None),
    ("/generate", {"input_ids": [1, 2], "topk": 2, "tree_style": "beam"},
     400, "item 8"),
    ("/generate_batch", {"prompts": [[1, 2]], "max_new_tokens": 4}, 400,
     "item 8"),
])
def test_error_reporting(servers, path, body, status, match):
    """A malformed request is a 4xx, not a 500; an unknown path 404; tree
    and batch requests 400 naming ``ROADMAP.md`` Queue 1 item 8."""
    mine, _, _ = servers
    got, out = _post(mine.port, path, body)
    assert got == status
    assert "error" in out
    if match:
        assert match in out["error"]


def test_malformed_body_is_a_400(servers):
    mine, _, _ = servers
    conn = http.client.HTTPConnection("127.0.0.1", mine.port, timeout=30)
    try:
        conn.request("POST", "/generate", b"{not json",
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400
        assert json.loads(resp.read()) == {"error": "malformed JSON body"}
    finally:
        conn.close()


@pytest.mark.parametrize("argv,item", [
    (["--export", "{peagle}"], "item 8b"),
    (["--shard-over-devices", "2"], "item 8e"),
])
def test_main_refuses_by_name(capsys, tmp_path, argv, item):
    """A P-EAGLE export (item 8b) and a device mesh (item 8e) are refused
    before anything loads."""
    peagle = tmp_path / "peagle"
    peagle.mkdir()
    (peagle / "config.json").write_text(json.dumps(
        {"architectures": ["PEagleDraftModel"], "vocab_size": V}))
    argv = [a.format(peagle=peagle) for a in argv]
    with pytest.raises(SystemExit) as exc:
        serving_server_main.main(["--target", "t", "--export", "e", *argv])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


def _read_ready(proc, timeout):
    """The served process's port from its READY line, read with a
    deadline."""
    found = {}

    def read():
        for line in proc.stdout:
            if line.startswith("READY port="):
                found["port"] = int(line.split("=", 1)[1])
                return

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout)
    assert "port" in found, "the server printed no READY line in time"
    return found["port"]


def test_serving_gate_end_to_end(tmp_path):
    """``scripts/gates/serving_gate.py`` with the port alone: a tiny ``cli
    train`` and ``cli export --to sglang``, then ``serving_server_main``
    (fp32 target) in a subprocess: ``/health``, then ``/generate`` equal
    to the target's greedy output and to JAX's decoder on the same
    export."""
    target, export, seqs, _ = train_and_export(tmp_path, epochs=1)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "specforge_tpu_torch.inference.serving_server_main", "--target",
         target, "--export", export, "--draft-tokens", "3", "--max-len",
         "256", "--port", "0", "--dtype", "float32", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    try:
        port = _read_ready(proc, READY_TIMEOUT)
        status, health = _request(port, "GET", "/health")
        assert status == 200 and health["num_draft_tokens"] == 3
        prompt = [int(t) for t in seqs[0][:8]]
        status, got = _post(port, "/generate", {"input_ids": prompt,
                                                "max_new_tokens": 16})
        assert status == 200
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=STOP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=STOP_TIMEOUT)
    assert proc.returncode is not None

    jparams, jcfg, pparams, pcfg = both_targets(target)
    greedy = spec_decode.greedy_target_decode(pparams, pcfg, prompt, 16,
                                              max_len=256)
    # the served tokens: the greedy ones, and JAX's on the same export (the
    # last round may run past the tokens asked for by a draft-dependent
    # count, so the runs are held over those)
    np.testing.assert_array_equal(got["output_ids"][:len(greedy)], greedy)
    module, variables = jax_exported_draft(
        export, np.asarray(jparams["model.embed_tokens.weight"]),
        dtype=jnp.bfloat16)
    n = jcfg.num_hidden_layers
    want = jax_sd.Eagle3SpecDecoder(
        jparams, jcfg, module, variables,
        capture_layers=(1, n // 2 - 1, n - 4), num_draft_tokens=3,
        max_len=256).generate_fused(prompt, max_new_tokens=16)
    np.testing.assert_array_equal(got["output_ids"][:len(greedy)],
                                  want.output_ids[:len(greedy)])


# --------------------------------------------------------------------------
# the block decoder behind the server
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_servers(tmp_path_factory):
    """The port's server and JAX's over the same 6-layer target and random
    Domino draft (blocks of 4, capture layers (1, 4)), max_len 128."""
    jparams, jcfg, pparams, pcfg = both_targets(
        save_llama(tmp_path_factory.mktemp("block_target")))
    raw = draft_config("domino")
    cfg = JaxDFlashConfig.from_dict(raw)
    module = JAX_CLASSES["domino"](cfg, dtype=jnp.float32,
                                   attn_chunk_blocks=1)
    variables = jax_init(module, cfg)
    draft = port_draft("domino", raw, params_from_jax(variables))
    jdec = jax_sd.DFlashSpecDecoder(jparams, jcfg, module, variables,
                                    max_len=128)
    pdec = spec_decode.DFlashSpecDecoder(pparams, pcfg, draft, max_len=128,
                                         device="cpu")
    mine, ref = SpecServingServer(pdec, port=0), JaxServer(jdec, port=0)
    mine.start()
    ref.start()
    yield mine, ref, pdec
    mine.stop()
    ref.stop()


@pytest.mark.parametrize("plain", [False, True])
def test_block_generate_matches_decoder_and_jax(block_servers, plain):
    """``/generate`` in block and plain mode over the block decoder: JAX's
    server's answer on the same weights, the decoder's tokens and accept
    lengths, and the same output in both modes."""
    mine, ref, decoder = block_servers
    prompt = np.random.default_rng(2).integers(0, V - 1, size=11).tolist()
    body = {"input_ids": prompt, "max_new_tokens": 12}
    if plain:
        body["plain"] = True
    status, got = _post(mine.port, "/generate", body)
    assert status == 200
    _, want = _post(ref.port, "/generate", body)
    assert set(got) == set(want)
    for key in ("output_ids", "new_tokens", "accept_lengths",
                "mean_accept_length", "rounds"):
        assert got.get(key) == want.get(key), key
    spec = decoder.generate_fused(prompt, max_new_tokens=12)
    n = min(len(got["output_ids"]), len(spec.output_ids))
    np.testing.assert_array_equal(got["output_ids"][:n], spec.output_ids[:n])
    if not plain:
        assert got["accept_lengths"] == spec.accept_lengths
        assert got["rounds"] == spec.steps


def test_block_health_and_refusals(block_servers):
    """``/health`` of a block decoder: JAX's fields, ``block_size`` and no
    ``num_draft_tokens``; a tree request is a 400, and ``/generate_batch``
    a 400 naming ``ROADMAP.md`` Queue 1 item 8d."""
    mine, ref, _ = block_servers
    (s1, got), (s2, want) = (_request(mine.port, "GET", "/health"),
                             _request(ref.port, "GET", "/health"))
    assert s1 == s2 == 200
    assert set(got) == set(want)
    for key in ("status", "family", "max_len", "block_size"):
        assert got[key] == want[key], key
    assert got["family"] == "DFlashSpecDecoder" and got["block_size"] == 4
    assert "num_draft_tokens" not in got
    status, out = _post(mine.port, "/generate", {"input_ids": [1, 2],
                                                 "topk": 2})
    assert status == 400 and "one block" in out["error"]
    status, out = _post(mine.port, "/generate_batch",
                        {"prompts": [[1, 2]], "max_new_tokens": 4})
    assert status == 400 and "item 8d" in out["error"]


def test_block_server_main_end_to_end(tmp_path, monkeypatch):
    """``serving_server_main --family dflash`` in a subprocess (fp32
    target) on a port export of a Domino draft: ``/health`` with its block
    size, then block and ``plain`` ``/generate`` equal to the in-process
    decoder built by the loaders on the same files, and to JAX's decoder
    on the same export; ``--family eagle3`` on that export is refused."""
    target = save_llama(tmp_path / "target")
    export = both_exports(tmp_path, monkeypatch, "domino", "port")
    with pytest.raises(SystemExit):
        serving_server_main.main(["--target", target, "--export", export])
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "specforge_tpu_torch.inference.serving_server_main", "--family",
         "dflash", "--target", target, "--export", export, "--max-len",
         "128", "--port", "0", "--dtype", "float32", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    prompt = np.random.default_rng(4).integers(0, V - 1, size=9).tolist()
    body = {"input_ids": prompt, "max_new_tokens": 10}
    try:
        port = _read_ready(proc, READY_TIMEOUT)
        status, health = _request(port, "GET", "/health")
        assert status == 200 and health["block_size"] == 4
        status, got = _post(port, "/generate", body)
        assert status == 200
        status, plain = _post(port, "/generate", {**body, "plain": True})
        assert status == 200
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=STOP_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=STOP_TIMEOUT)

    decoder = serving_loaders.build_decoder(serving_loaders.load_spec_models(
        target, export, dtype=torch.float32, device="cpu"), max_len=128,
        device="cpu")
    want = decoder.generate_fused(prompt, max_new_tokens=10)
    assert got["output_ids"] == want.output_ids.tolist()
    assert got["accept_lengths"] == want.accept_lengths
    assert plain["output_ids"][:len(want.output_ids)] == (
        want.output_ids[:len(plain["output_ids"])].tolist())
    jparams, jcfg, _, _ = both_targets(target)
    module, variables = jax_loaders.load_exported_dflash_draft(export)
    ref = jax_sd.DFlashSpecDecoder(jparams, jcfg, module, variables,
                                   max_len=128).generate_fused(
        prompt, max_new_tokens=10)
    assert got["output_ids"] == [int(t) for t in ref.output_ids]
    assert got["accept_lengths"] == [int(a) for a in ref.accept_lengths]
