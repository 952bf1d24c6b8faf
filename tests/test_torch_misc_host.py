"""The port's host modules without a device path: rigctl
(misc.rigctl), the scheduler (misc.scheduler) and the speed tester
(utils.speed_tester), against the JAX package's.

rigctl and the scheduler are copies of the JAX modules: the JAX tests'
cases (tests/test_misc.py) run on the port, and a port client talks to a
JAX server and a JAX client to a port server over the line protocol, with
every reply held exactly. ``speed_test`` runs on the CPU (time.perf_counter
there) and must report a positive rate over the JAX harness's seeded
input; its numbers are not compared (they are CPU times).
"""

import socket
import time

import numpy as np
import pytest
import torch

from sdrpp_tpu.misc import rigctl as jrig
from sdrpp_tpu.misc import scheduler as jsched
from sdrpp_tpu_torch.misc import rigctl as trig
from sdrpp_tpu_torch.misc import scheduler as tsched
from sdrpp_tpu_torch.utils.speed_tester import report_table, speed_test

torch.set_num_threads(1)


class _Controller:
    """tests/test_misc.py's controller."""

    def __init__(self):
        self.freq = 100e6
        self.mode = "nfm"
        self.pb = 12500.0
        self.running = False

    def get_freq(self):
        return self.freq

    def set_freq(self, f):
        self.freq = f

    def get_mode(self):
        return self.mode, self.pb

    def set_mode(self, m, pb):
        self.mode = m
        self.pb = pb if pb > 0 else self.pb

    def start(self):
        self.running = True

    def stop(self):
        self.running = False


def _send(sock, line):
    """One command line and its reply (the reply may come in pieces)."""
    sock.sendall(line.encode() + b"\n")
    sock.settimeout(5.0)
    data = sock.recv(4096)
    deadline = time.monotonic() + 0.2
    sock.settimeout(0.05)
    while time.monotonic() < deadline:
        try:
            more = sock.recv(4096)
        except socket.timeout:
            break
        if not more:
            break
        data += more
    return data.decode()


SESSION = [("F 145500000", "RPRT 0\n"), ("f", "145500000\n"),
           ("M FM 12500", "RPRT 0\n"), ("m", "FM\n12500\n"),
           ("\\chk_vfo", "0\n"), ("v", "VFOA\n"), ("\\start", "RPRT 0\n"),
           ("XYZZY", "RPRT -11\n"), ("F notanumber", "RPRT -1\n")]


def test_rigctl_server():
    """tests/test_misc.py::test_rigctl_server on the port's server."""
    ctl = _Controller()
    srv = trig.RigctlServer(ctl)
    s = socket.create_connection(("127.0.0.1", srv.port))
    try:
        for line, want in SESSION:
            assert _send(s, line) == want, line
        assert ctl.freq == 145500000.0
        assert ctl.mode == "nfm" and ctl.pb == 12500.0 and ctl.running
    finally:
        s.close()
        srv.close()


def test_rigctl_servers_reply_alike():
    """Every reply of the session, and a \\dump_state, equal between the
    two packages' servers."""
    replies = []
    for mod in (jrig, trig):
        srv = mod.RigctlServer(_Controller())
        s = socket.create_connection(("127.0.0.1", srv.port))
        try:
            replies.append([_send(s, line) for line, _ in SESSION]
                           + [_send(s, "\\dump_state")])
        finally:
            s.close()
            srv.close()
    assert replies[0] == replies[1]


@pytest.mark.parametrize("client_mod,server_mod", [(trig, jrig), (jrig, trig),
                                                   (trig, trig)],
                         ids=["port-client-jax-server",
                              "jax-client-port-server", "port-both"])
def test_rigctl_client_against_server(client_mod, server_mod):
    """tests/test_misc.py::test_rigctl_client_against_server across the
    packages."""
    ctl = _Controller()
    srv = server_mod.RigctlServer(ctl)
    cli = client_mod.RigctlClient("127.0.0.1", srv.port)
    try:
        assert cli.set_freq(7074000)
        assert cli.get_freq() == 7074000.0
        assert cli.set_mode("USB", 2700)
        assert cli.get_mode() == ("USB", 2700.0)
        assert ctl.mode == "usb" and ctl.pb == 2700.0
    finally:
        cli.close()
        srv.close()


def _fire(mod):
    events = []
    s = mod.Scheduler()
    s.add(mod.Task("rec", 10.0, 20.0, on_start=lambda: events.append("rec+"),
                   on_end=lambda: events.append("rec-")))
    s.add(mod.Task("tune", 5.0, None, on_start=lambda: events.append("tune")))
    ticks = [s.tick(t) for t in (1.0, 6.0, 11.0, 25.0)]
    return ticks, events, [repr(t) for t in s.tasks()]


def test_scheduler_fires_in_order():
    """tests/test_misc.py::test_scheduler_fires_in_order on the port, and
    the same events as the JAX scheduler's."""
    ticks, events, left = _fire(tsched)
    assert ticks == [[], ["start:tune"], ["start:rec"], ["end:rec"]]
    assert events == ["tune", "rec+", "rec-"]
    assert len(left) == 1
    assert (ticks, events, left) == _fire(jsched)


def test_scheduler_remove():
    s = tsched.Scheduler()
    s.add(tsched.Task("a", 2.0, None))
    s.add(tsched.Task("b", 1.0, 3.0))
    assert [t.name for t in s.tasks()] == ["b", "a"]
    s.remove("b")
    assert [t.name for t in s.tasks()] == ["a"]


def test_speed_test_on_the_cpu():
    from sdrpp_tpu_torch.ops.fm import Quadrature

    blk = Quadrature(5000.0, 48000.0, device="cpu")
    r = speed_test(blk, 4096, iters=2, device="cpu")
    assert r["block_len"] == 4096 and r["device"] == "cpu"
    assert r["samples_per_sec"] > 0 and r["time_per_block_us"] > 0
    assert r["iters"] >= 2
    table = report_table({"quadrature": r})
    assert "quadrature" in table and "Msamp/s" in table


def test_speed_test_float_and_lead_shape():
    from sdrpp_tpu_torch.ops.scans import DCBlocker

    blk = DCBlocker(0.01, dtype=torch.float32, lead_shape=(2,), device="cpu")
    r = speed_test(blk, 2048, dtype=torch.float32, lead_shape=(2,), iters=2,
                   device="cpu")
    assert r["lead_shape"] == (2,)
    assert np.isclose(r["samples_per_sec"],
                      2 * 2048 / (r["time_per_block_us"] * 1e-6))
