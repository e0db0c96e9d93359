"""One torch thread per test process.

The tier-1 run puts 6 pytest-xdist workers on the host's cores.  With
torch's default of one intra-op thread per core in each of them the cores
are oversubscribed, and the port's small CPU ops spin on each other: three
training steps of the tiny ``video_swin_2x2`` UNet take 0.7 s alone and
80 s with five such neighbours at the default, 0.7 s at one thread each.
Every worker imports this module when it collects the suite, before it runs
any test, so the setting holds for all of a worker's tests.  Run alone, a
test file keeps torch's default.
"""
import torch

torch.set_num_threads(1)


def test_one_torch_thread_per_worker():
    assert torch.get_num_threads() == 1
