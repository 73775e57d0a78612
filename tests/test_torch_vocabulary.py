"""The port's metric and span name registry (``tpu_tfrecord_torch/vocabulary.py``)
against the JAX package's.

- The tables equal the JAX ones; the names only the port registers are
  listed here (``PORT_ONLY``: none, the port emits the JAX names).
- Every literal name at a ``METRICS.count`` / ``add`` / ``gauge`` /
  ``observe``, ``timed``, ``span``, ``instant``, ``record_span`` or
  ``record_instant`` call site under ``tpu_tfrecord_torch/`` is registered,
  under the kind of its call, and every f-string name rides a registered
  dynamic prefix (the rule of the JAX package's linter).
- ``is_registered``, ``registered_names`` and ``vocabulary_markdown`` agree.
"""

import ast
import os

import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import vocabulary as jvocab  # noqa: E402
from tpu_tfrecord_torch import vocabulary as vocab  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpu_tfrecord_torch")

#: names the port registers that the JAX registry lacks, by kind
PORT_ONLY = {"counter": set(), "stage": set(), "gauge": set(), "span": set()}

METHOD_KINDS = {"count": "counter", "counter": "counter", "add": "stage", "observe": "stage",
                "stage": "stage", "gauge": "gauge", "gauge_value": "gauge"}
SPAN_FUNCS = {"span", "instant", "record_span", "record_instant"}
SPAN_RECEIVERS = {"telemetry", "RECORDER", "_telemetry"}


def call_kind(node: ast.Call):
    """The vocabulary kind a call site names, or None when it is not a
    metrics or span call."""
    fn = node.func
    if isinstance(fn, ast.Name):
        if fn.id == "timed":
            return "stage"
        return "span" if fn.id in SPAN_FUNCS else None
    if not isinstance(fn, ast.Attribute):
        return None
    tail = ast.unparse(fn.value).rsplit(".", 1)[-1]
    if fn.attr in SPAN_FUNCS:
        return "span" if tail in SPAN_RECEIVERS else None
    kind = METHOD_KINDS.get(fn.attr)
    return kind if kind and tail.strip("_").lower() == "metrics" else None


def call_sites():
    """(file, line, kind, literal name or None, f-string prefix or None)
    of every metrics and span call with a first argument in the port."""
    out = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            for node in ast.walk(ast.parse(open(path).read(), filename=path)):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                kind = call_kind(node)
                if kind is None:
                    continue
                arg = node.args[0]
                rel = os.path.relpath(path, REPO)
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    out.append((rel, node.lineno, kind, arg.value, None))
                elif isinstance(arg, ast.JoinedStr) and arg.values and \
                        isinstance(arg.values[0], ast.Constant):
                    out.append((rel, node.lineno, kind, None, arg.values[0].value))
    return out


SITES = call_sites()


def test_call_sites_are_found():
    names = {s[3] for s in SITES}
    for want in ("cache.hits", "cache.serve", "cache.commit", "write.commit", "decode",
                 "batch", "serve.latency", "read.stall"):
        assert want in names, want


@pytest.mark.parametrize("kind", sorted(vocab.KINDS))
def test_registry_equals_jax_plus_port_only(kind):
    mine, theirs = vocab.KINDS[kind], jvocab.KINDS[kind]
    assert set(mine) - set(theirs) == PORT_ONLY[kind]
    assert set(theirs) <= set(mine)
    for name in theirs:
        assert mine[name] == theirs[name]
    assert vocab.DYNAMIC_PREFIXES == jvocab.DYNAMIC_PREFIXES
    assert vocab.DERIVED_SUFFIXES == jvocab.DERIVED_SUFFIXES


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s[0]}:{s[1]}")
def test_every_call_site_name_is_registered(site):
    path, line, kind, name, prefix = site
    if name is not None:
        assert vocab.is_registered(name, kind), f"{path}:{line}: {kind} {name!r}"
    else:
        assert any(prefix.startswith(p) for p in vocab.DYNAMIC_PREFIXES.get(kind, {})), \
            f"{path}:{line}: {kind} f-string {prefix!r}..."


@pytest.mark.parametrize("name,kind", [
    ("cache.hits", "counter"), ("cache.hits", "stage"), ("cache.serve.errors", None),
    ("read.retries.delta", "counter"), ("autotune.workers", "gauge"), ("train.loss", "stage"),
    ("nope", None), ("write.io", "span"), ("cache.open", "stage"), ("bogus.errors", None),
])
def test_is_registered_agrees(name, kind):
    assert vocab.is_registered(name, kind) == jvocab.is_registered(name, kind)


def test_registered_names_and_markdown_match():
    assert list(vocab.registered_names()) == list(jvocab.registered_names())
    for kind in vocab.KINDS:
        assert list(vocab.registered_names(kind)) == list(jvocab.registered_names(kind))
    assert vocab.vocabulary_markdown() == jvocab.vocabulary_markdown()
    md = vocab.vocabulary_markdown()
    assert md.startswith(vocab.VOCABULARY_BEGIN) and md.endswith(vocab.VOCABULARY_END)
