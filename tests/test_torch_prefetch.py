"""The port's device prefetcher (paddle_tpu_torch/io/prefetch.py) on the
CPU: the JAX package's lifecycle contract (tests/test_prefetch.py) and
`Trainer.data_iter` as a pure transport. On the CPU the prefetcher runs
without a stream; tests/test_torch_cuda.py checks the side-stream
handoff on the card.
"""
import gc
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.io.prefetch import DevicePrefetcher, prefetch_to_device
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.parallel.trainer import Trainer, TrainStepConfig


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"input_ids": rng.randint(0, 97, (2, 16)).astype(np.int32),
             "labels": rng.randint(0, 97, (2, 16)).astype(np.int32)}
            for _ in range(n)]


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)


def test_depth_bound_backpressures_producer():
    """The queue never holds more than `depth` batches, and a stalled
    consumer stalls the source instead of letting the worker run through
    the epoch."""
    pulled = []

    def src():
        for i in range(50):
            pulled.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    pf = DevicePrefetcher(src(), device="cpu", depth=3)
    try:
        _wait(lambda: pf.qsize() >= 3)
        assert pf.qsize() == 3
        time.sleep(0.2)               # a stalled consumer: no more pulls
        assert len(pulled) <= 3 + 1   # depth queued + one in the worker
        assert float(next(pf)["x"][0]) == 0.0
        _wait(lambda: len(pulled) >= 5)
        assert len(pulled) <= 3 + 2   # one refill + one in the worker
    finally:
        pf.close()


def test_exhaustion_and_order():
    batches = _batches(6)
    pf = DevicePrefetcher(iter(batches), device="cpu", depth=2)
    out = list(pf)
    assert len(out) == 6
    for want, got in zip(batches, out):
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()                        # idempotent after exhaustion


def test_nested_batches_and_non_array_leaves():
    src = [{"pair": (np.zeros(2, np.float32), torch.ones(3)), "tag": "a"}]
    with prefetch_to_device(iter(src), device="cpu") as pf:
        out = next(pf)
    assert isinstance(out["pair"], tuple)
    assert torch.equal(out["pair"][1], torch.ones(3))
    assert out["tag"] == "a"


def test_worker_exception_propagates_to_consumer():
    """The source's own exception object re-raises in the consumer, after
    the batches before it."""
    def src():
        yield {"x": np.zeros((2,), np.float32)}
        raise ValueError("boom-in-source")

    pf = DevicePrefetcher(src(), device="cpu", depth=2)
    next(pf)
    with pytest.raises(ValueError, match="boom-in-source"):
        next(pf)
    pf.close()


def test_close_mid_epoch_joins_worker():
    def src():
        i = 0
        while True:                   # only close() ends this
            yield {"x": np.full((2,), i, np.float32)}
            i += 1

    pf = DevicePrefetcher(src(), device="cpu", depth=2)
    _wait(lambda: pf.qsize() >= 2)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()                        # idempotent


def test_abandoned_prefetcher_is_collectable_and_thread_exits():
    def src():
        i = 0
        while True:
            yield {"x": np.full((2,), i, np.float32)}
            i += 1

    pf = DevicePrefetcher(src(), device="cpu", depth=2)
    thread = pf._thread
    next(pf)
    del pf
    gc.collect()
    thread.join(timeout=5)
    assert not thread.is_alive()


def _trainer():
    cfg = tllama.tiny_llama_config(num_hidden_layers=2, vocab_size=97,
                                   hidden_size=128, num_attention_heads=2,
                                   num_key_value_heads=1, loss_chunk=8)
    model = tllama.LlamaForCausalLM(cfg, device="cpu", seed=3)
    return Trainer(model, topt.AdamW(learning_rate=1e-3,
                                     parameters=model.named_parameters()),
                   TrainStepConfig(compute_dtype=None))


def test_data_iter_trajectory_is_bit_identical_to_unprefetched():
    batches = _batches(4, seed=3)
    t1 = _trainer()
    raw = [float(t1.step(b)) for b in batches]
    t2 = _trainer()
    with t2.data_iter(iter(batches), depth=2) as it:
        pre = [float(t2.step(b)) for b in it]
    assert raw == pre
    for (n, a), b in zip(t1.model.named_parameters(),
                         t2.model.parameters()):
        assert torch.equal(a, b), n


def test_step_moves_nothing_already_placed(monkeypatch):
    """A data_iter batch is on the model's device already: step() uses its
    tensors as they are."""
    tr = _trainer()
    with tr.data_iter(iter(_batches(1)), depth=1) as it:
        batch = next(it)
    seen = []
    run = tr._forward_backward
    monkeypatch.setattr(tr, "_forward_backward",
                        lambda b, backward=True: seen.append(b) or run(
                            b, backward))
    tr.step(batch)
    assert all(seen[0][k] is batch[k] for k in batch)


def test_slice_modules_import_without_jax_or_paddle_tpu():
    """The training slice's modules import neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import paddle_tpu_torch.io.prefetch, paddle_tpu_torch.nn.clip\n"
        "import paddle_tpu_torch.kernels.blockwise_ce\n"
        "import paddle_tpu_torch.optimizer.lr\n"
        "import paddle_tpu_torch.parallel.trainer\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " (m.split('.')[0] in ('paddle_tpu', 'jax', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
