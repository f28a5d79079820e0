"""Model-based property test: the collection vs a pure-Python model.

Applies a long randomized sequence of insert / bulk_insert / delete /
delete_many / update / reindex / snapshot / crash-reload operations to a
Collection and to an in-memory dict model, and asserts observable
equivalence (count, get(), exact top-1 search for stored vectors) at every
checkpoint. The reload uses a fresh Collection.load, so WAL replay and
snapshot restore are continuously exercised.

``tests/test_property_model.py`` (1 test, 3 parametrised cases) over
``vrod_tpu_torch``, the same seeds, configurations and model checks. The
stream lives in ``tools/fuzz_model.py`` (``chip_smoke.py`` runs it on the
card) and here drives a port collection and a ``vrod_tpu`` collection in
lockstep: both must hand out the same record ids, satisfy the model, and,
at every checkpoint, answer the same queries (a stored vector of each
sampled record, four random ones, top-5, unfiltered and with a
``within_ids`` filter) with the same hits, compared tie-aware as
``test_torch_slice.assert_same_hits`` does: ids equal, or scores within
1e-4 where the two packages' norms round a stored value apart.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from test_torch_slice import assert_same_hits

_spec = importlib.util.spec_from_file_location(
    "fuzz_model",
    Path(__file__).resolve().parents[1] / "tools" / "fuzz_model.py")
fuzz_model = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fuzz_model)


def jax_opens(root: Path, cfg_kw: dict):
    from vrod_tpu.collection import Collection
    from vrod_tpu.config import CollectionConfig
    cfg = CollectionConfig(name="m", dim=fuzz_model.DIM, segment_rows=64,
                           **cfg_kw)
    path = root / "m"
    return (lambda: Collection.create(path, cfg),
            lambda: Collection.load(path))


def compare_packages(seed):
    rng = np.random.default_rng(10_000 + seed)

    def compare(cols, model):
        port, ref = cols
        assert port.count == ref.count
        if not model:
            return
        sample = list(model)[:: max(len(model) // 5, 1)]
        q = np.concatenate([
            np.stack([model[r][0] for r in sample]),
            rng.standard_normal((4, fuzz_model.DIM)).astype(np.float32)])
        k = min(5, len(model))
        assert_same_hits(port.search_similar(q, k=k),
                         ref.search_similar(q, k=k))
        subset = list(model)[:: max(len(model) // 7, 1)]
        assert_same_hits(port.search_similar(q, k=1, within_ids=subset),
                         ref.search_similar(q, k=1, within_ids=subset))

    return compare


@pytest.mark.parametrize("seed,cfg_kw", fuzz_model.CONFIGS)
def test_random_ops_match_model(tmp_path, seed, cfg_kw):
    opens = [fuzz_model.port_opens(tmp_path / "port", cfg_kw,
                                   device="cpu"),
             jax_opens(tmp_path / "jax", cfg_kw)]
    fuzz_model.run_stream(opens, seed, compare=compare_packages(seed))
