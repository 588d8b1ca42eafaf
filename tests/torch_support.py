"""Shared set-up of the port's test modules (``tests/test_torch_*.py``).

The resource-leak canary in ``conftest.py`` compares the temp dir's
``adaptdl-*`` entries before and after each test. Under pytest-xdist
every worker shares that dir, so a directory another worker's test
creates in the meantime (a warm-rescale successor's
``adaptdl-warmup-*``) was blamed on whichever test happened to be
running here. ``private_tempdir`` gives each port test module a temp
dir of its own for its whole run (``tempfile`` and ``TMPDIR``, which
child processes inherit): the canary then sees exactly what this
module's tests create. Import it into a test module to apply it.
"""

import tempfile

import pytest


@pytest.fixture(scope="module", autouse=True)
def private_tempdir(tmp_path_factory):
    path = tmp_path_factory.mktemp("tmp")
    previous = tempfile.tempdir
    tempfile.tempdir = str(path)
    try:
        with pytest.MonkeyPatch.context() as patch:
            patch.setenv("TMPDIR", str(path))
            yield path
    finally:
        tempfile.tempdir = previous


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's torch work on one intra-op thread. Under
    pytest-xdist every worker otherwise starts a thread per core, and the
    workers' small CPU kernels then contend for the cores: a CPU epoch of
    the LM example measured 10 s alone and 558 s beside five such
    workers. Import it into a test module to apply it."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
