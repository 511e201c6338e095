"""The window's arithmetic: every request's work over all the window's
time, and the tail over every request, on a synthetic stall."""

from perfbench import core


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _run(durations, seconds):
    clock = FakeClock()

    def request(i):
        clock.t += durations[i]

    return core.run_window(request, 10.0, seconds, clock=clock)


def test_rate_counts_all_the_window_with_a_stall():
    # 99 requests of 10 ms and one stall of 1 s: a 1.99-s window
    d = [0.01] * 50 + [1.0] + [0.01] * 49
    w = _run(d, 1.985)
    assert w.attempted == 100
    assert abs(w.seconds - 1.99) < 1e-9
    assert abs(w.rate() - 100 * 10.0 / 1.99) < 1e-6


def test_the_window_ends_with_the_request_that_crosses_it():
    w = _run([0.3] * 10, 1.0)
    assert w.attempted == 4 and abs(w.seconds - 1.2) < 1e-9


def test_p95_over_every_request():
    # 6 stalls in 100 requests: the 95th percentile is a stall
    d = [0.01] * 94 + [0.5] * 6
    w = _run(d, sum(d) - 1e-9)
    assert w.attempted == 100
    assert w.percentile_ms(95.0) == 500.0
    # 5 stalls: the 95th percentile is not
    d = [0.01] * 95 + [0.5] * 5
    w = _run(d, sum(d) - 1e-9)
    assert abs(w.percentile_ms(95.0) - 10.0) < 1e-9


def test_a_failed_request_is_counted_and_its_work_is_not():
    clock = FakeClock()
    seen = []

    def request(i):
        clock.t += 0.1
        if i == 1:
            raise RuntimeError("boom")

    w = core.run_window(request, 5.0, 0.25, clock=clock,
                        on_error=seen.append)
    assert w.attempted == 3 and w.failed == 1 and w.work == 10.0
    assert len(seen) == 1


def test_end_to_end_values():
    w = core.Window(seconds=2.0, latencies=[0.1, 0.2], work=4e6)
    assert core.end_to_end_value("render_mrays_s", w, 3.0, 0) == 2.0
    assert core.end_to_end_value("train_peak_gib", w, 3.0, 2 ** 31) == 2.0
    assert core.end_to_end_value("setup_s", w, 3.0, 0) == 3.0
    assert core.end_to_end_value("render_ms_p95", w, 3.0, 0) == 200.0
