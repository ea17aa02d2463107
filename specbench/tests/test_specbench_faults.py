"""The check against faults of the timed path: the harness's whole run on the
CPU at smoke size (no look for a card), once sound and once with each fault
a served cell can have planted in the program underneath; ``correct`` must
come out true, then false.  One card has no exchange between chips, so that
fault has no place here."""
import pytest
import torch

from specbench.tests import smoke

SEED = 2 ** 31 + 29


@pytest.fixture(params=["qwen2", "qwen2_moe"])
def kind(request):
    return request.param


def test_sound_run_is_correct(kind, monkeypatch):
    v = smoke.verdict(smoke.run(kind, SEED), SEED, monkeypatch)
    assert v["correct"], v


def test_token_altered_where_produced(kind, monkeypatch):
    from repro_torch.core import pipedec
    real, calls = pipedec.select_token, [0]

    def altered(logits, sp, gen=None):
        calls[0] += 1
        tok = real(logits, sp, gen)
        return (tok + 1) % logits.shape[-1] if calls[0] % 5 == 0 else tok
    monkeypatch.setattr(pipedec, "select_token", altered)
    v = smoke.verdict(smoke.run(kind, SEED), SEED, monkeypatch)
    assert not v["correct"], v


def test_commit_returns_the_state_unchanged(kind, monkeypatch):
    from repro_torch.serving import executor
    monkeypatch.setattr(executor.LocalFusedExecutor, "commit_rows",
                        lambda self, model_len, commit_mask: None)
    v = smoke.verdict(smoke.run(kind, SEED), SEED, monkeypatch)
    assert not v["correct"], v


def test_half_the_batch_left_out(kind, monkeypatch):
    """The target's verify logits of the bucket's second half of rows are
    the first half's: those rows are never computed."""
    from repro_torch.serving import executor
    real = executor.LocalFusedExecutor.verify_rows

    def half(self, *args):
        v_all, d_all = real(self, *args)
        nb = v_all.shape[0]
        if nb > 1:
            v_all = torch.cat([v_all[:nb // 2]] * 2)[:nb]
        return v_all, d_all
    monkeypatch.setattr(executor.LocalFusedExecutor, "verify_rows", half)
    v = smoke.verdict(smoke.run(kind, SEED), SEED, monkeypatch)
    assert not v["correct"], v


def test_a_missing_logit_row_fails_the_check(monkeypatch):
    """A served token whose row the program never produced is an answer
    that never came."""
    r = smoke.run("qwen2", SEED)
    uid = max(r.served, key=lambda u: len(r.served[u]))
    del r.logits.rows[uid][1]
    v = smoke.verdict(r, SEED, monkeypatch)
    assert not v["correct"], v


def test_the_sample_holds_the_longest_request():
    from specbench.lib import check
    r = smoke.run("qwen2", SEED)
    uids = check.sample(r, SEED)
    longest = max(len(t) for t in r.served.values())
    assert len(r.served[uids[0]]) == longest
    assert len(set(uids)) == len(uids) == min(r.mix["check"]["requests"],
                                              len(r.served))
    assert uids == check.sample(r, SEED)
