"""The port's host-side data and config modules against the JAX
package's: the same inputs give the same arrays, bit for bit
(tolerance: exact equality, dtypes included)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from idgrec_torch import config as t_config
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.data import graph as t_graph
from idgrec_tpu import config as j_config
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.data import graph as j_graph

_ARRAYS = ("train_user", "train_item", "row_ptr", "col_idx", "csr_vals",
           "test_user", "test_item")
_SCALARS = ("num_users", "num_items", "num_train", "num_test", "nnz", "num_nodes")


def _assert_same(t, j):
    for name in _SCALARS:
        assert getattr(t, name) == getattr(j, name), name
    for name in _ARRAYS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("shape,seed", [
    ((50, 80, 900, 200), 4),        # near-saturation branch (exact pair ids)
    ((300, 500, 4000, 800), 0),     # rejection-sampling branch
])
def test_synthetic_dataset_bit_equal(shape, seed):
    t = t_dataset.make_synthetic_dataset(*shape, seed=seed)
    j = j_dataset.make_synthetic_dataset(*shape, seed=seed)
    _assert_same(t, j)
    assert bool(np.all(t.csr_vals == 1))


def test_from_pairs_duplicates_and_implicit_sizes():
    rng = np.random.default_rng(7)
    tu, ti = rng.integers(0, 30, 400), rng.integers(0, 40, 400)  # with duplicates
    su, si = rng.integers(0, 33, 50), rng.integers(0, 41, 50)
    t = t_dataset.Dataset.from_pairs(tu, ti, su, si)
    j = j_dataset.Dataset.from_pairs(tu, ti, su, si)
    _assert_same(t, j)
    assert t.csr_vals.max() > 1


def test_load_reference_format(tmp_path, tiny_dataset):
    t = t_dataset.Dataset.load(tiny_dataset.path, name="tiny")
    _assert_same(t, tiny_dataset)
    assert t.pos_length == tiny_dataset.pos_length
    for u in range(t.num_users):
        np.testing.assert_array_equal(t.positive_items(u), tiny_dataset.positive_items(u))


def test_degrees_and_inv_pow_bit_equal():
    data = t_dataset.make_synthetic_dataset(40, 60, 500, 100, seed=3)
    jdata = j_dataset.make_synthetic_dataset(40, 60, 500, 100, seed=3)
    for a, b in zip(t_graph._degrees(data), j_graph._degrees(jdata)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = np.array([0.0, 1.0, 2.0, 7.0, 1e6])
    for p in (0.5, 1.0, 0.25):
        np.testing.assert_array_equal(t_graph._inv_pow(x.copy(), p), j_graph._inv_pow(x.copy(), p))


def test_config_parsing_matches(tmp_path):
    text = ("# comment\nembedding_size = 64\ntop_K = [10, 20]\nbroken line\n"
            "learn_rate=0.001\nflag = yes\n")
    path = tmp_path / "M.txt"
    path.write_text(text)
    t = t_config.read_configuration(str(path))
    j = j_config.read_configuration(str(path))
    assert t.as_dict() == j.as_dict()
    assert t.int_list("top_K") == j.int_list("top_K") == [10, 20]
    assert t.float("learn_rate") == j.float("learn_rate")
    assert t.bool("flag") is j.bool("flag") is True
    with pytest.raises(t_config.ConfigError):
        t.int("missing_key")


@pytest.mark.parametrize("name", ["LightGCN", "EGCF"])
def test_port_config_copy_is_the_jax_file_byte_for_byte(name):
    """The port's default for LightGCN and EGCF is the JAX package's:
    bfloat16 on ``auto``; a run that means int8 sets it itself."""
    root = Path(__file__).resolve().parent.parent
    assert (root / "idgrec_torch" / "configure" / f"{name}.txt").read_bytes() == \
        (root / "idgrec_tpu" / "configure" / f"{name}.txt").read_bytes()
    t = t_config.load_model_config(name)
    assert t.as_dict() == j_config.load_model_config(name).as_dict()
    assert t.str("compute_dtype", "bfloat16") == "bfloat16"


