"""Galaxy-calibrated synthetic workflow-history generator.

The thesis mined 508 (Ch. 4) / 534 (Ch. 5) real Galaxy workflows; those JSONs
are not redistributable here, so this generator produces histories matched to
the published corpus-level statistics:

  * ~7165 intermediate states over 508 pipelines -> mean length ~ 14.1
  * TSFR stores 457/508 finals                   -> ~10% exact-duplicate reruns
  * PT stores ~49 results reused ~5.4x each      -> heavy per-dataset protocol
    sharing: pipelines on a dataset start from a small set of standard
    "protocol stems" (FastQC -> trim -> align ...) and diverge in the tail.

Generative model: datasets with Zipf popularity; each dataset owns 1-3
protocol templates; a new pipeline on dataset d either (a) exactly re-runs a
previous pipeline, or (b) keeps a (usually full) prefix of a template and
regenerates the suffix — the thesis' "users frequently run similar workflows
by changing only a few modules".  The adaptive variant attaches per-module
tool states and perturbs them with a small probability (Ch. 5: state
mismatches reduce reuse from ~52% to ~40%).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .workflow import ModuleRef, ToolState, Workflow


@dataclass
class CorpusSpec:
    n_workflows: int = 508
    n_datasets: int = 26
    zipf_a: float = 1.15
    n_modules: int = 220  # Galaxy tool vocabulary scale
    mean_len: float = 14.1
    min_len: int = 3
    stem_frac: float = 0.62  # fraction of a pipeline that is protocol stem
    p_dup: float = 0.11  # exact re-run of a previous pipeline on same dataset
    p_fresh: float = 0.26  # completely novel pipeline (no protocol template)
    p_partial_stem: float = 0.25  # chance of truncating the stem
    templates_per_dataset: tuple[int, int] = (1, 3)
    # adaptive variant:
    with_state: bool = False
    states_per_module: int = 3
    p_state_perturb: float = 0.3  # chance a pipeline perturbs one stem state
    seed: int = 0


class _Gen:
    def __init__(self, spec: CorpusSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.templates: dict[str, list[list[ModuleRef]]] = {}
        self.history: dict[str, list[list[ModuleRef]]] = {}

    def _state(self, module: int) -> ToolState:
        if not self.spec.with_state:
            return ToolState()
        s = int(min(self.rng.geometric(0.6) - 1, self.spec.states_per_module - 1))
        return ToolState.from_config({"cfg": f"m{module}s{s}"})

    def _chain(self, n: int) -> list[ModuleRef]:
        # first-order walk over the tool vocabulary (tools cluster into stages)
        cur = int(self.rng.integers(self.spec.n_modules))
        out = []
        for _ in range(n):
            out.append(ModuleRef(f"M{cur}", self._state(cur)))
            cur = (cur + int(self.rng.integers(1, 6))) % self.spec.n_modules
        return out

    def _length(self) -> int:
        s = self.spec
        return max(s.min_len, int(self.rng.poisson(s.mean_len - s.min_len)) + s.min_len)

    def _dataset_templates(self, d: str) -> list[list[ModuleRef]]:
        if d not in self.templates:
            lo, hi = self.spec.templates_per_dataset
            k = int(self.rng.integers(lo, hi + 1))
            stem_len = max(2, int(round(self.spec.mean_len * self.spec.stem_frac)))
            self.templates[d] = [self._chain(stem_len) for _ in range(k)]
        return self.templates[d]

    def _perturb_states(self, mods: list[ModuleRef]) -> list[ModuleRef]:
        if not self.spec.with_state or not mods:
            return mods
        if self.rng.random() < self.spec.p_state_perturb:
            i = int(self.rng.integers(len(mods)))
            mods = list(mods)
            mid = int(mods[i].module_id[1:])
            mods[i] = ModuleRef(mods[i].module_id, self._state(mid + 7))
        return mods

    def pipeline(self, d: str) -> list[ModuleRef]:
        hist = self.history.setdefault(d, [])
        r = self.rng.random()
        if hist and r < self.spec.p_dup:
            mods = list(hist[int(self.rng.integers(len(hist)))])
        elif r < self.spec.p_dup + self.spec.p_fresh:
            mods = self._chain(self._length())
        else:
            templates = self._dataset_templates(d)
            # skew toward the dataset's primary protocol
            w = np.asarray([2.0**-i for i in range(len(templates))])
            t = templates[int(self.rng.choice(len(templates), p=w / w.sum()))]
            keep = len(t)
            if self.rng.random() < self.spec.p_partial_stem:
                keep = int(self.rng.integers(1, len(t) + 1))
            mods = list(t[:keep])
            n_suffix = max(1, self._length() - keep)
            mods = mods + self._chain(n_suffix)
            mods = self._perturb_states(mods)
        hist.append(mods)
        return mods


def generate_corpus(spec: CorpusSpec | None = None, **overrides) -> list[Workflow]:
    if spec is None:
        spec = CorpusSpec(**overrides)
    elif overrides:
        raise ValueError("pass either spec or overrides, not both")
    gen = _Gen(spec)
    rng = gen.rng

    ranks = np.arange(1, spec.n_datasets + 1, dtype=np.float64)
    probs = ranks ** (-spec.zipf_a)
    probs /= probs.sum()

    corpus: list[Workflow] = []
    for i in range(spec.n_workflows):
        d = f"D{int(rng.choice(spec.n_datasets, p=probs))}"
        mods = gen.pipeline(d)
        corpus.append(Workflow(d, tuple(mods), workflow_id=f"W{i}"))
    return corpus


def galaxy_ch4_corpus(seed: int = 0) -> list[Workflow]:
    """~508 pipelines, no tool states (thesis Ch. 4 setting)."""
    return generate_corpus(CorpusSpec(seed=seed))


def galaxy_ch5_corpus(seed: int = 0) -> list[Workflow]:
    """~534 pipelines with per-module tool states (thesis Ch. 5 setting)."""
    return generate_corpus(
        CorpusSpec(
            n_workflows=534,
            mean_len=15.9,
            with_state=True,
            p_state_perturb=0.5,
            seed=seed,
        )
    )
