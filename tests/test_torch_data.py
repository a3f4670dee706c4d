"""The port's SynthFEMNIST copy gives byte-equal arrays to the reference."""
import numpy as np
import pytest

from repro.data import synthetic as jdata
from repro_torch.data import synthetic as tdata

FIELDS = ("images", "labels", "counts", "test_images", "test_labels",
          "test_counts")


@pytest.mark.parametrize("num_clients,mean_samples,seed",
                         [(8, 8, 0), (16, 20, 3)])
def test_synth_femnist_is_byte_equal(num_clients, mean_samples, seed):
    ref = jdata.make_synth_femnist(num_clients=num_clients,
                                   mean_samples=mean_samples, seed=seed)
    port = tdata.make_synth_femnist(num_clients=num_clients,
                                    mean_samples=mean_samples, seed=seed)
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for k in range(num_clients):
        np.testing.assert_array_equal(port.label_histogram(k),
                                      ref.label_histogram(k))
    assert port.num_clients == ref.num_clients
