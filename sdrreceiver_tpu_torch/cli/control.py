"""Runtime control channel for live receive (the reference's GUI knobs).

Port of ``sdrreceiver_tpu.cli.control`` (host code only).  The reference
retunes through its spinbox -> rtlsdr_set_center_freq (mainwindow.cpp:570-583,
sdrj.cpp:190-200); VFO mixers stay fixed, so the whole channel plan shifts
with the dongle.  Headless equivalent: a UDP JSON socket on localhost.

    echo '{"set_center_freq": 1545600000}' | nc -u -w1 127.0.0.1 <port>
    echo '{"set_bias_tee": 1}' | nc -u -w1 127.0.0.1 <port>
    echo '{"stats": true}' | nc -u -w1 127.0.0.1 <port>   (replies with JSON)

With ``run --scope`` the reference's scope controls are live too (combo-box
VFO select and FFT on/off, mainwindow.cpp:539-566,616-626):

    echo '{"set_scope": "VFO05"}' | nc -u -w1 127.0.0.1 <port>
    echo '{"set_fft": 0}'        | nc -u -w1 127.0.0.1 <port>
    echo '{"spectrum": 512}'     | nc -u -w1 127.0.0.1 <port>  (smoothed dB curve)

Bias-tee control (sdrj.cpp:202-238) needs a local USB source
(``io/rtlusb.RtlUsbDevice``); rtl_tcp has no bias-tee command, so on a
remote source it answers with an error.  The server thread never touches
the receiver's tensors: the handlers it calls are host objects.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import traceback

__all__ = ["ControlServer"]


class ControlServer:
    def __init__(
        self,
        port: int,
        rtl_client=None,
        stats_fn=None,
        host: str = "127.0.0.1",
        commands: dict | None = None,
    ):
        """``port`` 0 picks a free one (read :attr:`port`).  ``commands``:
        extra ``{name: fn(value) -> reply dict}`` handlers, such as a
        LiveScope's set_scope/set_fft/spectrum."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.5)
        self.port = self._sock.getsockname()[1]
        self._client = rtl_client
        self._stats_fn = stats_fn
        self._commands = dict(commands or {})
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, name="control", daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                req = json.loads(data.decode())
            except ValueError:
                self._reply(addr, {"error": "invalid json"})
                continue
            try:
                rsp = self._handle(req)
            except Exception as e:  # a bad request must not end the server
                traceback.print_exc(file=sys.stderr)
                rsp = {"error": f"{type(e).__name__}: {e}"}
            self._reply(addr, rsp)

    def _handle(self, req) -> dict:
        if not isinstance(req, dict):
            return {"error": "unknown command"}
        if "set_center_freq" in req:
            freq = int(req["set_center_freq"])
            if self._client is None:
                return {"error": "no tunable source (file input)"}
            try:
                self._client.set_center_freq(freq)
            except OSError as e:  # socket errors: report, keep serving
                return {"error": str(e)}
            return {"ok": True, "center_freq": freq}
        if "set_bias_tee" in req:
            on = bool(int(req["set_bias_tee"]))
            if self._client is None or not hasattr(self._client, "set_bias_tee"):
                return {"error": "bias tee needs a local USB device"}
            res = self._client.set_bias_tee(on)
            if res != 0:
                return {"error": f"rtlsdr_set_bias_tee failed: {res}"}
            return {"ok": True, "bias_tee": int(on)}
        if req.get("stats"):
            return self._stats_fn() if self._stats_fn else {"ok": True}
        for name, fn in self._commands.items():
            if name in req:
                return fn(req[name])
        return {"error": "unknown command"}

    def _reply(self, addr, obj: dict) -> None:
        try:
            self._sock.sendto(json.dumps(obj).encode(), addr)
        except OSError:
            pass

    def close(self) -> None:
        """Stop the server thread and close the socket."""
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._sock.close()
