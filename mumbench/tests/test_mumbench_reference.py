"""The plain reference (mumbench/reference.py) on tiny collections: equal to
the program's CPU path for every mix (strict, -k -1, -f 3, -g) and to the
program's oracle on edge cases (a run shared by every document, matches at
document ends, an interval at the last suffix-array row); a match set with
one length, offset or strand changed fails the comparison; the control
(left-maximality dropped) fails it on every mix; and no reference module
imports anything of the program. Exact comparisons: the limit is 0."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR, os.path.join(BENCH_DIR, "generators")):
    sys.path.insert(0, _p)

import reference  # noqa: E402
import run  # noqa: E402
from synth_collection import synth_collection  # noqa: E402

torch.set_num_threads(2)

MIXES = {"mum": dict(k=0, f=1, F=0), "partial_k1": dict(k=-1, f=1, F=0),
         "mem_f3": dict(k=0, f=3, F=0), "direct": dict(k=0, f=1, F=0),
         "k2_f0_F5": dict(k=2, f=0, F=5)}
BACKEND = {"direct": "direct"}


def _program(docs, mix, backend="pfp"):
    from mumemto_tpu_torch import engine, options
    from mumemto_tpu_torch.bench import rb_of
    opts = options.normalize(len(docs), quiet=True,
                             num_distinct_docs=mix["k"], rare_freq=mix["f"],
                             max_mem_freq=mix["F"])
    res = engine.find_matches(rb_of(docs), opts, device="cpu",
                              backend=backend, show_progress=False)
    return run.parse_output(res.output_bytes(), opts.mum_mode), opts


@pytest.mark.parametrize("seed", [1, 2**33 + 9])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_reference_equals_the_programs_cpu_path(mix, seed):
    docs = synth_collection(0.02, 4, seed=seed, snp_rate=0.01)
    got, _ = _program(docs, MIXES[mix], BACKEND.get(mix, "pfp"))
    want = reference.match_set(docs, **MIXES[mix])
    assert len(want) > 10
    assert run.mismatches(got, want) == 0


def _edge_docs(variant):
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 300)]
    docs = []
    for _ in range(3):
        d = base.copy()
        d[rng.integers(0, 300, 3)] = acgt[rng.integers(0, 4, 3)]
        t = np.full(30, ord("T"), np.uint8)
        a = np.full(30, ord("A"), np.uint8)
        d = {"t_run": np.concatenate([d[:100], t, t[:10], d[100:]]),
             "t_end": np.concatenate([d, t]),
             "a_start": np.concatenate([a, d]),
             "both_ends": np.concatenate([t[:25], d, a[:25]])}[variant]
        docs.append(d)
    return docs


@pytest.mark.parametrize("variant", ["t_run", "t_end", "a_start",
                                     "both_ends"])
@pytest.mark.parametrize("mix", ["mum", "partial_k1", "mem_f3", "k2_f0_F5"])
def test_reference_equals_the_oracle_on_edge_cases(variant, mix):
    from mumemto_tpu_torch.bench import rb_of
    from mumemto_tpu_torch.oracle import naive
    docs = _edge_docs(variant)
    got, opts = _program(docs, MIXES[mix])
    oracle = run.parse_output(naive.oracle_output(rb_of(docs), opts),
                              opts.mum_mode)
    want = reference.match_set(docs, **MIXES[mix])
    assert run.mismatches(oracle, want) == 0
    assert run.mismatches(got, want) == 0


def test_the_edge_cases_reach_the_last_suffix_array_row():
    """With a 40-base run of T in every document, the largest suffixes
    share more than min_len characters: the interval at the last row,
    which the reference's stack scan never closes, is there to be left
    out (the oracle test above holds the reference to that)."""
    text, _s, _h = reference.collection_text(_edge_docs("t_run"))
    sa, levels = reference.suffix_ranks(torch.from_numpy(text))
    lcp = reference.lcp_from_levels(sa, levels)
    assert text[int(sa[-1])] == ord("T")
    assert int(lcp[-1]) >= 20 and int(lcp[-2]) >= 20


@pytest.mark.parametrize("mix", ["mum", "mem_f3"])
@pytest.mark.parametrize("fault", ["length", "offset", "strand"])
def test_one_changed_field_fails_the_comparison(mix, fault):
    docs = synth_collection(0.02, 4, seed=3, snp_rate=0.01)
    want = reference.match_set(docs, **MIXES[mix])
    got = list(want)
    m = list(got[len(got) // 2])
    if fault == "length":
        m[0] += 1
    elif fault == "offset":
        m[1] = (m[1][0] + 1,) + m[1][1:]
    else:
        st = m[-1]
        m[-1] = ("-" if st[0] == "+" else "+",) + st[1:]
    got[len(got) // 2] = tuple(m)
    assert run.mismatches(got, want) == 2
    assert run.mismatches(got[:-1], want) >= 1


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_the_control_fails_on_every_mix(mix):
    """The control: the reference with left-maximality dropped, held to the
    comparison's limit of 0, on three seeds."""
    for seed in (11, 12, 13):
        docs = synth_collection(0.02, 4, seed=seed, snp_rate=0.01)
        want = reference.match_set(docs, **MIXES[mix])
        ctl = reference.match_set(docs, left_maximal=False, **MIXES[mix])
        assert run.mismatches(ctl, want) > 0


def test_resolve_options_follows_the_reference():
    assert reference.resolve_options(10, 0, 1, 0) == (10, 1, 10)
    assert reference.resolve_options(10, -1, 1, 0) == (9, 1, 10)
    assert reference.resolve_options(10, 0, 3, 0) == (10, 3, 30)
    assert reference.resolve_options(10, 1, 0, 1) == (2, 0, 0)
    assert reference.resolve_options(10, 12, 2, -3) == (10, 2, 7)
    with pytest.raises(ValueError):
        reference.match_set([np.frombuffer(b"ACGT" * 10, np.uint8)] * 3,
                            f=0, F=0)


def test_reference_modules_import_nothing_of_the_program():
    banned = {"mumemto_tpu_torch", "mumemto_tpu", "jax", "jaxlib", "flax"}
    for path in glob.glob(os.path.join(BENCH_DIR, "reference*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)
    code = ("import sys; sys.path.insert(0, %r); import reference; "
            "import numpy as np; reference.match_set("
            "[np.frombuffer(b'ACGTTGCAAC' * 5, np.uint8)] * 2); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (BENCH_DIR, banned))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=BENCH_DIR)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
