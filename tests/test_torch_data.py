"""Port parity: the synthetic datamodule and the diffusion dataset,
fdtpu_torch against fdtpu.  Generated arrays must be bit-identical; dataset
statistics (a float32 FFT in two libraries, then numpy) at atol 1e-6."""

import json

import numpy as np
import pytest

from fdtpu.data.datamodules import SyntheticDatamodule as JaxSynthetic
from fdtpu.data.dataset import DiffusionDataset as JaxDataset
from fdtpu_torch.data import DiffusionDataset, SyntheticDatamodule


def _both(tmp_path, **kw):
    j = JaxSynthetic(data_dir=tmp_path / "jax", **kw)
    p = SyntheticDatamodule(tmp_path / "port", **kw)
    for dm in (j, p):
        dm.prepare_data()
        dm.setup()
    return j, p


@pytest.mark.parametrize("n_channels", [1, 2])
def test_synthetic_arrays_are_bit_identical(tmp_path, n_channels):
    j, p = _both(tmp_path, max_len=17, num_samples=50, n_channels=n_channels, random_seed=3)
    assert p.dataset_name == j.dataset_name
    for a, b in ((p.X_train, j.X_train), (p.X_test, j.X_test)):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape == (50, 17, n_channels)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fourier, standardize", [(True, True), (True, False), (False, True)])
def test_dataset_statistics_match_jax(tmp_path, fourier, standardize):
    j, p = _both(tmp_path, max_len=16, num_samples=40, fourier_transform=fourier,
                 standardize=standardize)
    jm, js = j.feature_mean_and_std
    pm, ps = p.feature_mean_and_std
    np.testing.assert_allclose(pm, jm, atol=1e-6)
    np.testing.assert_allclose(ps, js, atol=1e-6)
    jd = JaxDataset(j.X_test, fourier_transform=fourier, standardize=standardize,
                    X_ref=j.X_train)
    pd = DiffusionDataset(p.X_test, fourier_transform=fourier, standardize=standardize,
                          X_ref=p.X_train)
    np.testing.assert_allclose(pd.standardized(), jd.standardized(), atol=1e-5)


def test_degenerate_std_falls_back_to_unit_scale():
    x = np.zeros((1, 8, 1), np.float32)
    d = DiffusionDataset(x, standardize=True)
    j = JaxDataset(x, standardize=True)
    np.testing.assert_array_equal(d.feature_std, j.feature_std)
    assert np.isfinite(d.standardized()).all()


def test_prepare_data_regenerates_on_parameter_change(tmp_path):
    dm = SyntheticDatamodule(tmp_path, max_len=16, num_samples=10)
    dm.prepare_data()
    meta = json.loads((tmp_path / "synthetic" / "synthetic_meta.json").read_text())
    assert meta["max_len"] == 16
    dm2 = SyntheticDatamodule(tmp_path, max_len=20, num_samples=10)
    dm2.prepare_data()
    dm2.setup()
    assert dm2.X_train.shape == (10, 20, 1)
