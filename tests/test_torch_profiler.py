"""The port's sampling profiler (`transferia_tpu_torch/stats/
profiler.py`) and the host library's `_ProfiledLib` proxy
(`transferia_tpu_torch/native`) against the JAX package's.

The JAX package's profiler cases (but the debug endpoint, which comes
with the CLI) run on both packages (`pkg`): the sampler finds the hot
function, renders its table, caps `sample_seconds`, tags samples taken
inside a native call with the native symbol, and the proxy marks each
host-library call.  The parity case holds the report's rendering of the
same counts equal in both packages; sampled timings are never compared.
"""

import threading
import time
from collections import Counter

import numpy as np
import pytest

from transferia_tpu import native as ref_native
from transferia_tpu.stats import profiler as ref_profiler
from transferia_tpu_torch import native as port_native
from transferia_tpu_torch.stats import profiler as port_profiler

PROF = {"jax": ref_profiler, "torch": port_profiler}
NATIVE = {"jax": ref_native, "torch": port_native}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return request.param


def _burn(deadline):
    x = 0
    while time.perf_counter() < deadline:
        for i in range(2000):
            x += i * i
    return x


def test_sampler_attributes_hot_function(pkg):
    prof = PROF[pkg]
    with prof.profile(hz=250, threads={threading.get_ident()}) as p:
        _burn(time.perf_counter() + 0.4)
    rep = p.report
    assert rep.samples > 20
    assert any("_burn" in loc for loc, _, _ in rep.top(5)), rep.top(5)
    assert 0.1 < sum(s for _, s, _ in rep.top(100)) <= rep.seconds + 0.1
    text = rep.format(5)
    assert "self" in text and "location" in text and "Hz" in text


def test_sample_seconds_caps(pkg):
    assert PROF[pkg].sample_seconds(0.1, hz=200).seconds < 1.0


def test_native_call_marker_scoped_and_reentrant(pkg):
    prof = PROF[pkg]
    ident = threading.get_ident()
    assert prof.active_native(ident) is None
    with prof.native_call("outer_sym"):
        assert prof.active_native(ident) == "outer_sym"
        with prof.native_call("inner_sym"):
            assert prof.active_native(ident) == "inner_sym"
        assert prof.active_native(ident) == "outer_sym"
    assert prof.active_native(ident) is None


def test_sampler_tags_native_bound_frames(pkg):
    prof = PROF[pkg]
    stop = threading.Event()

    def burner():
        with prof.native_call("hmac_sha256_hex"):
            x = 0
            while not stop.is_set():
                x += 1

    th = threading.Thread(target=burner, name="native-burner")
    th.start()
    try:
        s = prof.Sampler(hz=250, threads={th.ident}).start()
        time.sleep(0.4)
        rep = s.stop()
    finally:
        stop.set()
        th.join()
    tagged = [loc for loc in rep.self_counts
              if prof.NATIVE_TAG in loc and "hmac_sha256_hex" in loc]
    assert tagged, dict(rep.self_counts)
    assert any("burner" in loc for loc in tagged)


def test_profiled_lib_proxy_marks_calls_and_forwards(pkg):
    prof, native = PROF[pkg], NATIVE[pkg]

    class _FakeCdll:
        version = 7

    fake = _FakeCdll()
    seen = {}

    def myfn(x):
        seen["during"] = prof.active_native(threading.get_ident())
        return x + 1

    fake.myfn = myfn
    lib = native._ProfiledLib(fake)
    assert lib.version == 7
    assert lib.myfn(41) == 42
    assert seen["during"] == "myfn"
    assert prof.active_native(threading.get_ident()) is None
    assert hasattr(lib, "myfn") and not hasattr(lib, "no_such_symbol")
    assert lib.myfn is lib.myfn


def test_port_host_library_is_proxied_and_marks_calls():
    lib = port_native.lib()
    assert isinstance(lib, port_native._ProfiledLib)
    seen = []
    real = lib._cdll.crc32c_buf

    class _Spy:
        def __getattr__(self, name):
            fn = getattr(lib._cdll, name)
            if name != "crc32c_buf":
                return fn

            def spy(*args):
                seen.append(port_profiler.active_native(
                    threading.get_ident()))
                return real(*args)
            return spy

    spied = port_native._ProfiledLib(_Spy())
    data = np.frombuffer(b"123456789", np.uint8)
    assert spied.crc32c_buf(data, 9, 0) == lib.crc32c_buf(data, 9, 0) \
        == ref_native.lib().crc32c_buf(data, 9, 0)
    assert seen == ["crc32c_buf"]


def test_report_rendering_equals_jax():
    texts = []
    for prof in (ref_profiler, port_profiler):
        rep = prof.ProfileReport(seconds=2.0, samples=40, idle_samples=7,
                                 rate_hz=97.0)
        rep.self_counts = Counter({"a (x.py:1)": 0.5, "b (y.py:2)": 0.25,
                                   "[native hostops] c": 0.125})
        texts.append((rep.format(2), rep.top(3), rep.cpu_seconds))
    assert texts[0] == texts[1]
