"""``CheckpointManager.save(..., wait=False)`` and ``wait_until_finished``
(``nf_tpu/utils/serialization.py:80-94``), on the CPU: the files an
asynchronous save writes are byte for byte those of a synchronous one,
pending saves land in order and ``max_to_keep`` prunes as it would
synchronously, a restore after ``wait_until_finished`` is bitwise, and
the snapshot is taken before ``save`` returns, so a step that rewrites the
tensors in place right after it changes nothing written."""

import os

import torch

import nf_tpu_torch as nt
from nf_tpu_torch import utils as tutils
from nf_tpu_torch.utils import serialization


def _state(seed):
    """A small ``build_nsf`` TrainState after one Adam step (so the
    optimizer has state tensors) and a generator."""
    torch.manual_seed(seed)
    model = nt.build_nsf(dim=2, K=2, hidden=8, num_bins=4, num_blocks=1,
                         device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    state = nt.init_train_state(model, opt)
    loss = -model.log_prob(torch.randn(16, 2)).mean()
    loss.backward()
    opt.step()
    return state, torch.Generator().manual_seed(seed)


def _file(manager, step):
    with open(os.path.join(manager._dir(step), serialization._STATE_FILE),
              "rb") as f:
        return f.read()


def test_async_files_are_byte_for_byte_the_sync_ones(tmp_path):
    state, gen = _state(0)
    sync = tutils.CheckpointManager(tmp_path / "sync")
    sync.save(3, state, generator=gen)
    lazy = tutils.CheckpointManager(tmp_path / "async")
    lazy.save(3, state, generator=gen, wait=False)
    lazy.wait_until_finished()
    assert _file(lazy, 3) == _file(sync, 3)


def test_pending_saves_land_in_order_and_prune(tmp_path):
    state, gen = _state(1)
    manager = tutils.CheckpointManager(tmp_path, max_to_keep=2)
    files = {}
    for step in (1, 2, 3):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(0.25)
        state.step = step
        manager.save(step, state, generator=gen, wait=False)
        ref = tutils.CheckpointManager(tmp_path / f"ref{step}")
        ref.save(step, state, generator=gen)
        files[step] = _file(ref, step)
    manager.wait_until_finished()
    assert manager.all_steps() == [2, 3]
    for step in (2, 3):
        assert _file(manager, step) == files[step]


def test_snapshot_is_taken_before_save_returns(tmp_path):
    """Rewriting the parameters in place right after an asynchronous save
    (what the next replay of a captured step does) leaves the write as it
    was when ``save`` was called."""
    state, gen = _state(2)
    ref = tutils.CheckpointManager(tmp_path / "ref")
    ref.save(5, state, generator=gen)
    manager = tutils.CheckpointManager(tmp_path / "async")
    manager.save(5, state, generator=gen, wait=False)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(-3.0)
    manager.wait_until_finished()
    assert _file(manager, 5) == _file(ref, 5)


def test_restore_after_an_async_save_is_bitwise(tmp_path):
    state, gen = _state(3)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_want = {i: {k: v.clone() for k, v in st.items()
                    if torch.is_tensor(v)}
                for i, st in enumerate(state.optimizer.state.values())}
    gen_want = gen.get_state()
    manager = tutils.CheckpointManager(tmp_path)
    manager.save(7, state, generator=gen, wait=False)
    manager.wait_until_finished()
    with torch.no_grad():
        for p in state.model.parameters():
            p.zero_()
    for st in state.optimizer.state.values():
        for v in st.values():
            if torch.is_tensor(v):
                v.zero_()
    gen.manual_seed(99)
    got, step = manager.restore(state, generator=gen)
    assert step == 7 and got is state
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k])
    for i, st in enumerate(state.optimizer.state.values()):
        for k, v in opt_want[i].items():
            assert torch.equal(st[k], v)
    assert torch.equal(gen.get_state(), gen_want)


def test_restore_waits_for_a_pending_write(tmp_path):
    state, gen = _state(4)
    manager = tutils.CheckpointManager(tmp_path)
    manager.save(9, state, generator=gen, wait=False)
    _, step = manager.restore(state, generator=gen)
    assert step == 9 and not manager._pending
