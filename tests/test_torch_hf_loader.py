"""Model-path resolution in the port (`modeling/hf_loader.py`) against
the JAX package's `resolve_model_path`, on the CPU.

No test here reaches a network: an autouse fixture replaces
`huggingface_hub.snapshot_download` with a stand-in that fails the test
if called, and the tests that resolve a model id install their own,
which hands back a local copy of the tiny model.

- A local directory or file passes through in both packages (the
  pattern of tests/test_weight_loading.py::test_resolve_model_path_local).
- A model id resolves under `$APHRODITE_CACHE/<org--name>.lock`, held
  while the hub call runs, with the JAX package's `allow_patterns`; both
  packages return the same path under the same patch.
- `APHRODITE_USE_MODELSCOPE` goes through a stub `modelscope` module,
  and without the package both raise the same `ImportError`.
- `--model org/tiny` builds an engine whose greedy tokens equal the
  local path's; the weight iterator reads the resolved directory.
- Resolving and serving a local path imports no `huggingface_hub`
  (checked in a fresh interpreter).
"""
import fcntl
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(load_format="dummy", dtype="float32", block_size=16,
                 max_model_len=128, max_num_seqs=4, swap_space=0.01)
PATTERNS = ["*.safetensors", "*.bin", "*.json", "*.model", "*.txt"]


@pytest.fixture(autouse=True)
def _no_hub(monkeypatch, tmp_path):
    import huggingface_hub

    def refuse(*args, **kwargs):
        raise AssertionError(f"unexpected hub call {args} {kwargs}")
    monkeypatch.setattr(huggingface_hub, "snapshot_download", refuse)
    monkeypatch.setenv("APHRODITE_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("APHRODITE_USE_MODELSCOPE", raising=False)


def _resolvers():
    from aphrodite_tpu.modeling.hf_loader import (
        resolve_model_path as jax_resolve)
    from aphrodite_tpu_torch.modeling.hf_loader import resolve_model_path
    return jax_resolve, resolve_model_path


def _fake_hub(monkeypatch, target, calls):
    """Install a snapshot_download that records its calls, checks the
    per-repo lock is held while it runs, and returns `target`."""
    import huggingface_hub

    def snapshot_download(repo_id, **kwargs):
        lock = os.path.join(os.environ["APHRODITE_CACHE"],
                            repo_id.replace("/", "--") + ".lock")
        with open(lock) as f:
            with pytest.raises(BlockingIOError):
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        calls.append((repo_id, kwargs))
        return target
    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        snapshot_download)


def test_resolve_model_path_local(tmp_path):
    for resolve in _resolvers():
        assert resolve(str(tmp_path)) == str(tmp_path)
        f = tmp_path / "m.gguf"
        f.touch()
        assert resolve(str(f)) == str(f)


def test_model_id_resolves_under_a_lock_as_in_jax(tmp_path, monkeypatch):
    calls = []
    _fake_hub(monkeypatch, str(tmp_path / "snapshot"), calls)
    got = [resolve("org/tiny") for resolve in _resolvers()]
    assert got == [str(tmp_path / "snapshot")] * 2
    assert calls == [("org/tiny", {"allow_patterns": PATTERNS})] * 2
    assert os.listdir(tmp_path / "cache") == ["org--tiny.lock"]
    # The lock is released once the call returns.
    with open(tmp_path / "cache" / "org--tiny.lock") as f:
        fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)


def test_modelscope_branch_as_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("APHRODITE_USE_MODELSCOPE", "1")
    calls = []
    stub = types.ModuleType("modelscope.hub.snapshot_download")

    def ms_snapshot_download(model_id):
        calls.append(model_id)
        return str(tmp_path / "ms")
    stub.snapshot_download = ms_snapshot_download
    monkeypatch.setitem(sys.modules, "modelscope",
                        types.ModuleType("modelscope"))
    monkeypatch.setitem(sys.modules, "modelscope.hub",
                        types.ModuleType("modelscope.hub"))
    monkeypatch.setitem(sys.modules, "modelscope.hub.snapshot_download",
                        stub)
    assert [r("org/tiny") for r in _resolvers()] == \
        [str(tmp_path / "ms")] * 2
    assert calls == ["org/tiny"] * 2
    assert os.listdir(tmp_path / "cache") == ["org--tiny.lock"]
    # Without the package: the same ImportError text in both.
    for name in ("modelscope", "modelscope.hub",
                 "modelscope.hub.snapshot_download"):
        monkeypatch.setitem(sys.modules, name, None)
    errors = []
    for resolve in _resolvers():
        with pytest.raises(ImportError) as info:
            resolve("org/tiny")
        errors.append(str(info.value))
    assert errors[0] == errors[1] == (
        "APHRODITE_USE_MODELSCOPE is set but the modelscope package is "
        "not installed")


def test_model_id_engine_matches_local_path(tiny_model_dir, tmp_path,
                                            monkeypatch):
    """`EngineArgs(model="org/tiny")` resolves through the (patched)
    hub; `LLM`'s greedy tokens equal the local path's, and the served
    model name stays the string given. A `.bin` in the snapshot is
    read by the weight iterator through the same resolution."""
    from aphrodite_tpu_torch.common.sampling_params import SamplingParams
    from aphrodite_tpu_torch.endpoints.llm import LLM
    from aphrodite_tpu_torch.engine.args_tools import EngineArgs
    from aphrodite_tpu_torch.modeling import loader
    snapshot = tmp_path / "snapshot"
    shutil.copytree(tiny_model_dir, snapshot)
    calls = []
    _fake_hub(monkeypatch, str(snapshot), calls)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model_cfg = EngineArgs(model="org/tiny", device="cpu",
                               **ENGINE_KW).create_engine_configs()[0]
        assert model_cfg.model == "org/tiny"
        assert model_cfg.hf_config.hidden_size == 64
        params = SamplingParams(temperature=0.0, max_tokens=12,
                                ignore_eos=True)
        prompts = ["the quick brown fox", "hello world"]
        tokens = []
        for model in ("org/tiny", tiny_model_dir):
            llm = LLM(model=model, tokenizer=tiny_model_dir, device="cpu",
                      **ENGINE_KW)
            tokens.append([o.outputs[0].token_ids
                           for o in llm.generate(prompts, params)])
            del llm
    finally:
        torch.set_num_threads(threads)
    assert tokens[0] == tokens[1]
    assert all(len(t) == 12 for t in tokens[0])
    assert calls and all(c == ("org/tiny", {"allow_patterns": PATTERNS})
                         for c in calls)
    torch.save({"w": torch.arange(6.0)}, snapshot / "pytorch_model.bin")
    [(name, w)] = list(loader._weights_iterator("org/tiny", "pt"))
    assert name == "w" and torch.equal(w, torch.arange(6.0))


def test_missing_local_path_is_refused_without_a_hub_call(tmp_path,
                                                         monkeypatch):
    """An absolute path that does not exist is no model id: the hub
    package's own check (`validate_repo_id`, which its
    `snapshot_download` runs before any request) refuses it, and
    `get_config` says so."""
    import huggingface_hub
    from huggingface_hub.utils import validate_repo_id
    from aphrodite_tpu_torch.transformers_utils.config import get_config

    def snapshot_download(repo_id, **kwargs):
        validate_repo_id(repo_id)
        raise AssertionError(f"{repo_id!r} passed as a model id")
    monkeypatch.setattr(huggingface_hub, "snapshot_download",
                        snapshot_download)
    with pytest.raises(ValueError, match="neither a local model directory"):
        get_config(str(tmp_path / "missing"))


def test_local_path_imports_no_hub_package(tiny_model_dir, tmp_path):
    """The card machine has no `huggingface_hub`: resolving a local
    directory, reading its config and weights and building an engine on
    it must not import one."""
    torch.save({"w": torch.zeros(2)}, tmp_path / "pytorch_model.bin")
    shutil.copy(os.path.join(tiny_model_dir, "config.json"), tmp_path)
    script = f"""
import sys
from aphrodite_tpu_torch.engine.aphrodite_engine import AphroditeEngine
from aphrodite_tpu_torch.engine.args_tools import EngineArgs
from aphrodite_tpu_torch.modeling import loader
from aphrodite_tpu_torch.modeling.hf_loader import resolve_model_path
from aphrodite_tpu_torch.transformers_utils.config import get_config
path = {str(tmp_path)!r}
assert resolve_model_path(path) == path
assert get_config(path).hidden_size == 64
assert [n for n, _ in loader._weights_iterator(path, "pt")] == ["w"]
AphroditeEngine.from_engine_args(EngineArgs(
    model=path, device="cpu", load_format="dummy", dtype="float32",
    max_model_len=128, swap_space=0.01, skip_tokenizer_init=True,
    disable_log_stats=True))
print(json.dumps(sorted(m for m in ("huggingface_hub", "modelscope",
                                    "transformers") if m in sys.modules)))
"""
    out = subprocess.run(
        [sys.executable, "-c", "import json\n" + script], cwd=REPO,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
