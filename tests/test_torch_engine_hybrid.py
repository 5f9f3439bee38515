"""The port's continuous-batching ``ServeEngine`` against the JAX
reference on reduced recurrentgemma-2b at one pattern period of 13
layers (RG-LRU states beside ring caches), on the CPU: the reference's
three ``TestServeEngine`` cases (``tests/torch_engine_helpers.py``), as
``tests/test_torch_engine.py`` does for the dense archs.  Each request's
tokens must equal the reference's ``generate`` of that request alone,
exactly.

The reference's own engine is no yardstick here: its ``_insert_slot``
takes a stacked leaf whose super-block axis has length 1 (one pattern
period) for a (B, ...) leaf and writes it along the wrong axis, so at
13 layers it decodes other tokens than its own ``generate`` (ROADMAP §3,
reference caveats); the port's per-layer insertion has no such case.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402,F401

import torch_engine_helpers as E  # noqa: E402

ARCH = "recurrentgemma-2b"


def test_engine_matches_single_request_generate():
    E.check_matches_generate(ARCH, (7, 19), 64)


def test_engine_more_requests_than_slots():
    E.check_more_requests_than_slots(ARCH, 64)


def test_engine_eos_stops_early():
    E.check_eos_stops_early(ARCH)
