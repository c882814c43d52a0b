"""Torch's intra-op pool at one thread for the port's heavier test files.

Their small models run thousands of tiny operators, each a parallel region
whose threads wait for one another. Under pytest-xdist every worker's pool
has a thread a core, so six workers on eight cores keep far more busy threads
than cores, and a region waits for threads that are not running. On an
8-core host with ``-n 6``, ``test_torch_port_m2ae.py``,
``test_torch_port_m2ae_cli.py`` and ``test_torch_port_pretrain_cli.py`` took
165 s of wall time with ``OMP_NUM_THREADS=1`` against 492 s with the default
pool; the data-parallel scenarios ran about ten times as fast at one thread.
One thread also makes the port's side of a test independent of the host's
core count. A test file takes it by importing the fixture::

    from _torch_threads import torch_at_one_thread  # noqa: F401

``test_torch_port_pretrain_cli.py`` does not: its resumed run of a small,
chaotic model (``test_resume_after_a_crash_equals_the_jax_clis``) lands
2.4e-4 from the JAX CLI's at one thread, outside its 2e-4, and within it at
the default pool, where its bound was set.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_torch_thread():
    """Torch's intra-op pool at one thread for the block."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def torch_at_one_thread():
    """Every test of the importing module, and its module fixtures, at one
    torch thread."""
    with one_torch_thread():
        yield
