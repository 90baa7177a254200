"""The sres trainer CLI on two processes: the tests of
tests/test_torch_parallel_cli.py, which says what they check."""

import pytest

from test_torch_parallel_cli import (  # noqa: F401
    make_runs, test_g_ema_checkpoint_matches_one_process, test_one_run_dir_and_only_rank0_writes,
    test_resume_on_two_ranks_continues, test_several_processes_need_a_seed,
    test_train_checkpoint_matches_one_process)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs("sres", tmp_path_factory)
