"""The rest of paddle.device, the TensorArray ops and the reference's
top-level extras (places, flags, printing, `batch`, rng state) of
paddle_tpu_torch against paddle_tpu's, on the CPU.

On the CPU the memory queries keep the reference's documented answers:
the process's peak RSS for `max_memory_allocated`, 0 for the others
(the CUDA answers are held against torch.cuda's by the card tests).
`CUDAPlace` prints the CUDA device, where the reference's prints its
TPU (a deliberate difference, ROADMAP.md queue C);
`set_flags({"FLAGS_check_nan_inf": True})` arms the NaN/Inf check of
every eager op, as the reference's: `paddle.log` of a negative number
then raises and records the reference's `nan_detected` event.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as port


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = port.device._current
    port.set_device("cpu")
    yield
    port.device._current = prev


def _np(x):
    return np.asarray(x.numpy())


EXTRAS = ["CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "NPUPlace",
          "TPUPlace", "_memcpy", "get_flags", "set_flags", "enable_static",
          "disable_static", "in_dynamic_mode", "is_grad_enabled_",
          "set_printoptions", "batch", "get_cuda_rng_state",
          "set_cuda_rng_state", "disable_signal_handler", "check_shape",
          "bool", "create_array", "array_read", "array_write",
          "array_length"]
DEVICE = ["get_device_properties", "cuda", "Stream", "Event",
          "max_memory_allocated", "memory_allocated", "max_memory_reserved",
          "memory_reserved", "get_cudnn_version", "XPUPlace", "IPUPlace",
          "MLUPlace", "get_all_device_type", "get_all_custom_device_type",
          "get_available_device", "get_available_custom_device"]


def test_the_reference_names_exist():
    for n in EXTRAS:
        assert hasattr(ref, n) and hasattr(port, n), n
    for n in DEVICE + list(ref.device.__all__):
        assert hasattr(port.device, n), n
    for n in ref.device.cuda.__all__:
        assert hasattr(port.device.cuda, n), n


def test_arrays_match_reference():
    out = {}
    for pkg in (ref, port):
        x = pkg.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        arr = pkg.create_array("float32", [x])
        arr = pkg.array_write(x * 2, pkg.to_tensor(np.int64([3])), arr)
        arr = pkg.array_write(x + 1, 1, arr)
        out[pkg] = ([_np(t) for t in arr],
                    _np(pkg.array_length(arr)),
                    _np(pkg.array_read(arr, pkg.to_tensor(np.int64([3])))),
                    len(pkg.array_write(x, 0)))
        with pytest.raises(TypeError):
            pkg.create_array("float32", [np.zeros(2)])
        with pytest.raises(IndexError):
            pkg.array_write(x, -1, arr)
    (ra, rl, rr, rn), (pa, pl, pr, pn) = out[ref], out[port]
    assert len(pa) == len(ra) == 4 and rn == pn == 1
    for r, p in zip(ra, pa):
        np.testing.assert_array_equal(p, r)
        assert p.dtype == r.dtype
    np.testing.assert_array_equal(pl, rl)
    assert pl.dtype == rl.dtype == np.int64
    np.testing.assert_array_equal(pr, rr)


def test_cpu_memory_answers_and_gauges():
    from paddle_tpu_torch.profiler import monitor
    import resource
    peak = port.device.max_memory_allocated()
    assert peak >= resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 \
        - (1 << 30) and peak > 0
    assert port.device.memory_allocated() == 0
    assert port.device.max_memory_reserved() == 0
    assert port.device.memory_reserved() == 0
    assert port.device.cuda.max_memory_allocated() >= peak
    assert monitor.gauge("device.peak_bytes").value >= peak
    assert monitor.gauge("device.bytes_in_use").value == 0
    props = port.device.get_device_properties()
    assert props.name == "cpu" and props.multi_processor_count == 1


def test_memory_queries_on_the_default_device_need_a_card():
    """The port's rule: the current device is CUDA unless the CPU was
    asked for; without a card the query raises instead of answering for
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    prev = port.device._current
    port.device._current = None
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            port.device.max_memory_allocated()
    finally:
        port.device._current = prev


def test_events_and_streams_on_the_cpu():
    s = port.device.Stream()
    start, end = port.device.Event(enable_timing=True), \
        port.device.Event(enable_timing=True)
    start.record(s)
    sum(range(10000))
    s.record_event(end)
    assert start.query() and s.query()
    s.synchronize()
    end.synchronize()
    s.wait_event(end)
    s.wait_stream(port.device.Stream())
    assert start.elapsed_time(end) >= 0
    with pytest.raises(RuntimeError):
        port.device.Event().elapsed_time(end)


def test_places_match_reference_but_cuda_names_the_card():
    for name in ("CPUPlace", "CUDAPinnedPlace"):
        assert repr(getattr(port, name)()) == repr(getattr(ref, name)())
    for name in ("CUDAPlace", "NPUPlace", "TPUPlace"):
        assert repr(getattr(port, name)(1)) == "Place(gpu:1)"
        assert repr(getattr(ref, name)(1)) == "Place(tpu:1)"
    for name in ("XPUPlace", "MLUPlace"):
        assert repr(getattr(port.device, name)(2)) == \
            repr(getattr(ref.device, name)(2))
        assert getattr(port.device, name)(2).get_device_id() == 2
    assert port.device.IPUPlace().get_device_id() == 0
    x = port.to_tensor(np.arange(3, dtype=np.float32))
    y = port._memcpy(x, port.CPUPlace())
    assert y.place == "cpu" and y.value.data_ptr() != x.value.data_ptr()
    np.testing.assert_array_equal(_np(y), _np(x))
    np.testing.assert_array_equal(_np(port._memcpy(x)), _np(x))


def test_device_type_queries():
    assert port.device.get_all_device_type()[0] == "cpu"
    assert port.device.get_all_custom_device_type() == \
        ref.device.get_all_custom_device_type() == []
    assert port.device.get_available_custom_device() == []
    assert port.device.get_available_device() == \
        port.device.get_all_devices()
    v = port.device.get_cudnn_version()
    assert v is None or isinstance(v, int)
    assert port.device.cuda.device_count() == torch.cuda.device_count()
    port.device.cuda.empty_cache()
    port.device.cuda.synchronize()


def test_flags_match_reference():
    assert sorted(port.get_flags()) == sorted(ref.get_flags())
    for k in ("FLAGS_check_nan_inf", "FLAGS_use_cinn",
              "FLAGS_eager_delete_tensor_gb"):
        assert port.get_flags(k) == ref.get_flags(k)
    prev = torch.backends.cudnn.deterministic
    try:
        port.set_flags({"FLAGS_cudnn_deterministic": not prev})
        assert torch.backends.cudnn.deterministic is (not prev)
        assert port.get_flags(["FLAGS_cudnn_deterministic"]) == {
            "FLAGS_cudnn_deterministic": not prev}
    finally:
        torch.backends.cudnn.deterministic = prev
    port.set_flags({"FLAGS_eager_delete_tensor_gb": 1.0,
                    "FLAGS_check_nan_inf": False})
    assert port.get_flags("FLAGS_eager_delete_tensor_gb") == {
        "FLAGS_eager_delete_tensor_gb": 1.0}
    port.set_flags({"FLAGS_eager_delete_tensor_gb": 0.0})
    # FLAGS_check_nan_inf arms the eager ops' check, on both packages
    from paddle_tpu.profiler import flight_recorder as ref_flight
    from paddle_tpu_torch.profiler import flight_recorder as port_flight
    events = []
    for pkg, fr in ((ref, ref_flight), (port, port_flight)):
        fr.reset()
        pkg.set_flags({"FLAGS_check_nan_inf": True})
        try:
            assert pkg.get_flags("FLAGS_check_nan_inf") == {
                "FLAGS_check_nan_inf": True}
            x = pkg.to_tensor(np.array([-1.0, 4.0], np.float32))
            assert _np(pkg.sqrt(pkg.abs(x))).tolist() == [1.0, 2.0]
            with pytest.raises(FloatingPointError, match="1 NaNs, 0 Infs"):
                pkg.log(x)
        finally:
            pkg.set_flags({"FLAGS_check_nan_inf": False})
        events.append([{k: v for k, v in e.items() if k != "ts"}
                       for e in fr.snapshot()["events"]])
        assert _np(pkg.log(x))[1] == np.float32(np.log(4.0))  # disarmed
    assert events[0] == events[1] == [
        {"event": "nan_detected", "op": "log", "n_nan": 1, "n_inf": 0,
         "where": "eager"}]
    assert port.get_flags("FLAGS_check_nan_inf") == {
        "FLAGS_check_nan_inf": False}


def test_static_mode_flag_and_grad_query():
    for pkg in (ref, port):
        assert pkg.in_dynamic_mode()
        pkg.enable_static()
        assert not pkg.in_dynamic_mode()
        pkg.disable_static()
        assert pkg.in_dynamic_mode()
        assert pkg.is_grad_enabled_() == pkg.is_grad_enabled()
        assert pkg.check_shape([1]) is None
        assert pkg.disable_signal_handler() is None


def test_batch_matches_reference():
    for drop_last in (False, True):
        r = list(ref.batch(lambda: iter(range(7)), 3, drop_last)())
        p = list(port.batch(lambda: iter(range(7)), 3, drop_last)())
        assert p == r


def test_set_printoptions_matches_reference():
    a = np.float32([1.123456789, 2e-5, 3.0])
    prev = np.get_printoptions()
    try:
        for kw in ({"precision": 3}, {"precision": 6, "sci_mode": True},
                   {"threshold": 2, "edgeitems": 1, "linewidth": 40}):
            ref.set_printoptions(**kw)
            want = str(ref.to_tensor(a).numpy())
            np.set_printoptions(**prev)
            port.set_printoptions(**kw)
            got = repr(port.to_tensor(a))
            assert got.endswith(want + ")"), (got, want)
            np.set_printoptions(**prev)
    finally:
        np.set_printoptions(**prev)


def test_rng_states_round_trip():
    state = port.get_rng_state()
    a = port.rand([4])
    port.set_rng_state(state)
    np.testing.assert_array_equal(_np(port.rand([4])), _np(a))
    cuda = port.get_cuda_rng_state()
    assert isinstance(cuda, list) and len(cuda) == torch.cuda.device_count()
    port.set_cuda_rng_state(cuda)
