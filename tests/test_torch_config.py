"""Config schema + name validation tests.

``tests/test_config.py`` (17 tests) over ``vrod_tpu_torch.config``: the
same cases and oracles; imports rewritten only.
"""

import pytest

from vrod_tpu_torch.config import (
    CollectionConfig, DatabaseConfig, validate_name,
)
from vrod_tpu_torch.errors import ConfigError


def test_collection_config_roundtrip():
    cfg = CollectionConfig(name="c1", dim=128, metric="l2",
                           dtype="bfloat16", segment_rows=64, shards=2)
    back = CollectionConfig.from_json(cfg.to_json())
    assert back == cfg


def test_config_validation():
    with pytest.raises(ConfigError):
        CollectionConfig(name="c", dim=0)
    with pytest.raises(ConfigError):
        CollectionConfig(name="c", dim=8, metric="hamming")
    with pytest.raises(ConfigError):
        CollectionConfig(name="c", dim=8, dtype="float16")
    with pytest.raises(ConfigError):
        CollectionConfig(name="c", dim=8, segment_rows=100)  # not mult of 8
    with pytest.raises(ConfigError):
        CollectionConfig(name="c", dim=8, shards=0)


@pytest.mark.parametrize("bad", [
    "../evil", "a/b", "a\\b", ".hidden", "", "-x", "a" * 200, "a b",
])
def test_name_validation_rejects(bad):
    with pytest.raises(ConfigError):
        validate_name(bad)


@pytest.mark.parametrize("good", ["c1", "my-col_2", "A.b-c", "x"])
def test_name_validation_accepts(good):
    assert validate_name(good) == good


def test_path_traversal_blocked(tmp_path):
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "safe")
    with pytest.raises(ConfigError):
        db.create_collection("../escape", dim=8, segment_rows=64)
    with pytest.raises(ConfigError):
        Database.new(tmp_path, "../escape")
    db.close()


def test_segment_rows_must_be_positive():
    import pytest
    from vrod_tpu_torch.config import CollectionConfig
    from vrod_tpu_torch.errors import ConfigError
    for bad in (0, -8):
        with pytest.raises(ConfigError, match="positive multiple"):
            CollectionConfig(name="x", dim=4, segment_rows=bad)


def test_name_rejects_trailing_newline():
    import pytest
    from vrod_tpu_torch.config import validate_name
    from vrod_tpu_torch.errors import ConfigError
    with pytest.raises(ConfigError):
        validate_name("mydb\n")
    with pytest.raises(ConfigError):
        validate_name("my\ndb")
