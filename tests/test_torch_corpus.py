"""The thesis's evaluation in the port (``repro_torch.core.{corpus,metrics,
adaptive}``), held against the reference package on the CPU.

The same seeds give the same Galaxy-calibrated corpora in both packages
(datasets, workflow ids, module ids and tool-state digests), and the replay
evaluator gives the same ``PolicyReport`` for every policy, with and without
tool states.  Every comparison is exact: the corpora come from numpy's
``default_rng`` in both packages and the reports are integer counts.  Then the
regime checks of ``tests/test_corpus_calibration.py`` and the policy
invariants of ``tests/test_policies.py`` run on the port.
"""
import dataclasses

import pytest
from _hypothesis_compat import HealthCheck, given, settings, st

from repro import core as jcore
from repro.core import adaptive as jadaptive
from repro_torch.core import (
    TSAR,
    TSFR,
    TSPAR,
    CorpusSpec,
    PolicyReport,
    RuleMiner,
    Workflow,
    adaptive_policy,
    adaptive_risp,
    evaluate_all,
    evaluate_policy,
    galaxy_ch4_corpus,
    galaxy_ch5_corpus,
    generate_corpus,
    make_policy,
)
from repro_torch.core.adaptive import prefix_state_match, states_match

POLICIES = ("PT", "TSAR", "TSPAR", "TSFR")


def _identity(corpus):
    """What makes a workflow the same one in both packages."""
    return [
        (wf.dataset_id, wf.workflow_id,
         tuple((m.module_id, m.state.digest) for m in wf.modules))
        for wf in corpus
    ]


def _fields(reports):
    return {name: dataclasses.asdict(r) for name, r in reports.items()}


@pytest.fixture(scope="module")
def ch5_reports():
    """The ch5 replay with tool states, once per package (about 10 s each)."""
    return (evaluate_all(galaxy_ch5_corpus(), with_state=True),
            jcore.evaluate_all(jcore.galaxy_ch5_corpus(), with_state=True))


@pytest.fixture(scope="module")
def ch4_reports():
    return evaluate_all(galaxy_ch4_corpus()), jcore.evaluate_all(jcore.galaxy_ch4_corpus())


# -- the corpora -------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", ["galaxy_ch4_corpus", "galaxy_ch5_corpus"])
def test_corpus_equals_reference(which, seed):
    ours = getattr(__import__("repro_torch.core", fromlist=[which]), which)(seed)
    ref = getattr(jcore, which)(seed)
    assert len(ours) == len(ref) == (508 if which.endswith("ch4_corpus") else 534)
    assert _identity(ours) == _identity(ref)
    # the prefix keys the policies index by are the same strings too
    for a, b in zip(ours[:40], ref[:40]):
        assert a.prefix(len(a)).key(True) == b.prefix(len(b)).key(True)


@pytest.mark.parametrize(
    "overrides",
    [
        {"n_workflows": 90, "n_datasets": 6, "n_modules": 30, "mean_len": 6, "seed": 7},
        {"n_workflows": 60, "with_state": True, "states_per_module": 5,
         "p_state_perturb": 0.9, "seed": 3},
        {"n_workflows": 70, "zipf_a": 2.0, "p_dup": 0.4, "p_fresh": 0.05,
         "templates_per_dataset": (2, 4), "min_len": 5, "seed": 11},
    ],
)
def test_corpus_spec_overrides_equal_reference(overrides):
    ours = generate_corpus(**overrides)
    ref = jcore.generate_corpus(**overrides)
    assert _identity(ours) == _identity(ref)
    assert _identity(generate_corpus(CorpusSpec(**overrides))) == _identity(ours)
    assert dataclasses.asdict(CorpusSpec(**overrides)) == dataclasses.asdict(
        jcore.CorpusSpec(**overrides))


def test_generate_corpus_rejects_spec_and_overrides():
    with pytest.raises(ValueError, match="not both"):
        generate_corpus(CorpusSpec(), seed=1)


# -- the replay evaluator -----------------------------------------------------------
def test_ch4_reports_equal_reference(ch4_reports):
    ours, ref = ch4_reports
    assert list(ours) == list(ref) == list(POLICIES)
    assert _fields(ours) == _fields(ref)
    assert [r.row() for r in ours.values()] == [r.row() for r in ref.values()]
    # the thesis's headline: PT reuse likeliness 51.97%
    assert ours["PT"].row()["LR_pct"] == 51.97
    assert (ours["PT"].n_stored, ours["TSAR"].n_stored, ours["TSPAR"].n_stored,
            ours["TSFR"].n_stored) == (67, 4302, 131, 447)


def test_ch5_reports_with_state_equal_reference(ch5_reports):
    ours, ref = ch5_reports
    assert _fields(ours) == _fields(ref)
    assert ours["PT"].row()["LR_pct"] == 49.81 and ours["PT"].n_stored == 91


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_small_corpus_reports_equal_reference(seed, with_state):
    spec = dict(n_workflows=120, n_datasets=8, n_modules=40, mean_len=8,
                with_state=with_state, seed=seed)
    ours = evaluate_all(generate_corpus(**spec), with_state=with_state)
    ref = jcore.evaluate_all(jcore.generate_corpus(**spec), with_state=with_state)
    assert _fields(ours) == _fields(ref)


def test_evaluate_policy_and_report_properties():
    corpus = generate_corpus(n_workflows=50, n_datasets=4, n_modules=20, mean_len=5)
    jcorpus = jcore.generate_corpus(n_workflows=50, n_datasets=4, n_modules=20,
                                    mean_len=5)
    ours = evaluate_policy(make_policy("TSPAR"), corpus)
    ref = jcore.evaluate_policy(jcore.make_policy("TSPAR"), jcorpus)
    assert isinstance(ours, PolicyReport)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.lr, ours.psrr, ours.frsr, ours.pisrs) == (ref.lr, ref.psrr, ref.frsr,
                                                           ref.pisrs)
    empty = PolicyReport("x", 0, 0, 0, 0, 0, 0)
    assert (empty.lr, empty.psrr, empty.frsr, empty.pisrs) == (0.0, 0.0, 0.0, 0.0)


# -- the adaptive helpers -----------------------------------------------------------
def test_adaptive_constructors_match_reference():
    for ours, ref in ((adaptive_risp(), jadaptive.adaptive_risp()),
                      *((adaptive_policy(n), jadaptive.adaptive_policy(n))
                        for n in POLICIES)):
        assert type(ours).__name__ == type(ref).__name__
        assert ours.name == ref.name and ours.with_state and ref.with_state
    corpus = galaxy_ch5_corpus()[:150]
    jcorpus = jcore.galaxy_ch5_corpus()[:150]
    ours = evaluate_policy(adaptive_policy("PT"), corpus)
    ref = jcore.evaluate_policy(jadaptive.adaptive_policy("PT"), jcorpus)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_state_matching_helpers_match_reference():
    corpus = galaxy_ch5_corpus(seed=1)[:60]
    jcorpus = jcore.galaxy_ch5_corpus(seed=1)[:60]
    pairs = [(i, j) for i in range(0, 60, 3) for j in range(1, 60, 7)]
    for i, j in pairs:
        a, b = corpus[i], corpus[j]
        ja, jb = jcorpus[i], jcorpus[j]
        assert states_match(a.modules[0], b.modules[0]) == jadaptive.states_match(
            ja.modules[0], jb.modules[0])
        n = min(len(a), len(b), 3)
        assert prefix_state_match(a.prefix(n), b.prefix(n)) == \
            jadaptive.prefix_state_match(ja.prefix(n), jb.prefix(n))
    wf = corpus[0]
    assert prefix_state_match(wf.prefix(2), wf.prefix(2))
    assert not prefix_state_match(wf.prefix(2), wf.prefix(3))


# -- the calibration regime (tests/test_corpus_calibration.py) -----------------------
def test_ch4_calibration_regime(ch4_reports):
    reports, _ = ch4_reports
    pt, tsar, tspar, tsfr = (reports[n] for n in POLICIES)
    assert 45 <= pt.lr <= 60
    assert pt.n_stored < 150
    assert pt.pisrs < 2.5
    assert tsar.lr > pt.lr >= tspar.lr > tsfr.lr
    assert pt.psrr > tspar.psrr > tsfr.psrr > tsar.psrr
    assert pt.frsr > tspar.frsr > tsfr.frsr > tsar.frsr
    assert tsfr.n_stored > 400


def test_ch5_adaptive_regime(ch4_reports, ch5_reports):
    pt = ch5_reports[0]["PT"]
    assert 35 <= pt.lr <= 60
    assert pt.n_stored < 200
    assert pt.lr <= ch4_reports[0]["PT"].lr + 1.0


# -- the policy invariants (tests/test_policies.py) -----------------------------------
def small_corpus(seed=0, n=60, with_state=False):
    return generate_corpus(CorpusSpec(n_workflows=n, n_datasets=6, n_modules=30,
                                      mean_len=6, with_state=with_state, seed=seed))


def test_tsar_stores_all_prefixes_dedup():
    pol = TSAR()
    pol.step(Workflow.build("D1", ["A", "B", "C"]))
    pol.step(Workflow.build("D1", ["A", "B", "D"]))
    assert pol.n_stored == 4
    assert pol.n_reusable_pipelines == 1


def test_tsfr_full_rerun_reuses_final():
    pol = TSFR()
    pol.step(Workflow.build("D1", ["A", "B"]))
    rec = pol.step(Workflow.build("D1", ["A", "B"]))
    assert rec.reuse is not None and rec.reuse.depth == 2
    assert pol.n_stored == 1


def test_tsfr_stored_final_usable_as_prefix():
    pol = TSFR()
    pol.step(Workflow.build("D1", ["A", "B"]))
    rec = pol.step(Workflow.build("D1", ["A", "B", "C"]))
    assert rec.reuse is not None and rec.reuse.depth == 2


def test_tspar_stores_only_previously_appeared():
    pol = TSPAR()
    assert pol.step(Workflow.build("D1", ["A", "B"])).store == []
    rec2 = pol.step(Workflow.build("D1", ["A", "C"]))
    assert len(rec2.store) == 1 and rec2.store[0].depth == 1


def test_reuse_is_longest_prefix():
    pol = TSAR()
    pol.step(Workflow.build("D1", ["A", "B", "C", "D"]))
    rec = pol.step(Workflow.build("D1", ["A", "B", "C", "E"]))
    assert rec.reuse is not None and rec.reuse.depth == 3


@settings(max_examples=20, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 10_000), with_state=st.booleans())
def test_metric_invariants(seed, with_state):
    corpus = small_corpus(seed=seed, with_state=with_state)
    reports = evaluate_all(corpus, with_state=with_state)
    pt, tsar, tspar, tsfr = (reports[n] for n in POLICIES)
    assert tsar.lr >= pt.lr and tsar.lr >= tspar.lr and tsar.lr >= tsfr.lr
    assert tsar.n_stored >= pt.n_stored
    assert tsar.n_stored >= tspar.n_stored
    assert tsar.n_stored >= tsfr.n_stored
    for r in reports.values():
        assert 0 <= r.pisrs <= 100.0
        assert 0 <= r.lr <= 100.0
        assert r.n_stored_reused <= r.n_stored
        assert r.total_intermediate_states == sum(len(w) for w in corpus)


@settings(max_examples=15, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 10_000))
def test_history_extension_monotone_support(seed):
    corpus = small_corpus(seed=seed, n=30)
    m = RuleMiner()
    probe = corpus[0].prefix(1)
    prev = 0
    for wf in corpus:
        m.add(wf)
        cur = m.support(probe)
        assert cur >= prev
        prev = cur


def test_pt_stores_at_most_one_per_pipeline():
    pol = make_policy("PT")
    for wf in small_corpus(seed=3):
        assert len(pol.step(wf).store) <= 1
    assert pol.n_stored <= 60
