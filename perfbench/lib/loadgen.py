"""The load generator: a child process of its own (so that its threads take
nothing from the server's interpreter lock) that sends the cell's requests
to ``POST /tts`` with ``"stream": true`` and times each on
``time.monotonic()``, a clock the parent shares.

Per request it keeps the time it was due, the time it was sent, the arrival
of every PCM chunk after the 44-byte WAV header (the time its last byte
arrived, and its size), the end of the stream, the HTTP status and the PCM
itself. The HTTP/1.1 chunked framing is read off the socket by hand, so a
chunk is timed when it arrives and not when a library buffer fills.

Loops: ``closed`` (``clients`` threads, each sending its next request when
its stream ends) and ``open`` (one request per due time, each on a thread
of its own, due times fixed in advance). No request is sent at or after
``stop_at``; the streams in flight run to their end, until ``give_up_at``.
"""

from __future__ import annotations

import json
import socket
import threading
import time

WAV_HEADER = 44


def stream_request(port: int, payload: dict, give_up_at: float) -> dict:
    """One streamed request; returns its record (times on the monotonic
    clock)."""
    rec = {"sent": time.monotonic(), "status": None, "chunks": [], "end": None,
           "error": None}
    pcm = bytearray()
    body = json.dumps(payload).encode()
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    except OSError as e:
        rec["error"] = f"connect: {e}"
        rec["pcm"] = b""
        return rec
    try:
        sock.sendall(b"POST /tts HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = bytearray()

        def fill() -> bool:
            """Wait for more bytes, however long, until the grace runs out."""
            while True:
                left = give_up_at - time.monotonic()
                if left <= 0:
                    raise TimeoutError("past the grace")
                sock.settimeout(min(left, 5.0))
                try:
                    data = sock.recv(1 << 16)
                except socket.timeout:
                    continue
                if not data:
                    return False
                buf.extend(data)
                return True

        while b"\r\n\r\n" not in buf:
            if not fill():
                raise ConnectionError("closed before the headers")
        head, _, rest = bytes(buf).partition(b"\r\n\r\n")
        buf[:] = rest
        lines = head.decode("latin-1").split("\r\n")
        rec["status"] = int(lines[0].split()[1])
        headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
        if rec["status"] != 200 or headers.get("transfer-encoding") != "chunked":
            n = int(headers.get("content-length", "0"))
            while len(buf) < n and fill():
                pass
            rec["error"] = bytes(buf[:300]).decode("utf-8", "replace")
            rec["pcm"] = b""
            return rec
        header_left = WAV_HEADER
        while True:
            while b"\r\n" not in buf:
                if not fill():
                    raise ConnectionError("stream cut inside a chunk size")
            line, _, rest = bytes(buf).partition(b"\r\n")
            buf[:] = rest
            size = int(line.split(b";")[0], 16)
            while len(buf) < size + 2:
                if not fill():
                    raise ConnectionError("stream cut inside a chunk")
            data = bytes(buf[:size])
            del buf[: size + 2]
            now = time.monotonic()
            if size == 0:
                rec["end"] = now
                break
            skip = min(header_left, len(data))
            header_left -= skip
            if len(data) > skip:
                rec["chunks"].append((now, len(data) - skip))
                pcm.extend(data[skip:])
    except (OSError, ValueError, TimeoutError, ConnectionError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        sock.close()
    rec["pcm"] = bytes(pcm)
    return rec


def cancelled_request(port: int, payload: dict, give_up_at: float) -> bool:
    """A warm-up request: stream until the first PCM chunk, then hang up
    (the server frees the row at its next segment). True if audio came."""
    body = json.dumps(payload).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=5.0) as sock:
        sock.sendall(b"POST /tts HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = 0
        while got <= 200 + WAV_HEADER:  # headers, the WAV header, and some PCM
            sock.settimeout(max(0.1, give_up_at - time.monotonic()))
            data = sock.recv(1 << 16)
            if not data:
                return False
            got += len(data)
        return True


def run(port: int, requests: list[dict], loop: str, clients: int, start_at: float,
        stop_at: float, give_up_at: float) -> list[dict]:
    """Send ``requests`` (each ``{"payload": ..., "due": offset_s}`` for the
    open loop) from ``start_at``; returns the records of those sent, in
    request order."""
    records: dict[int, dict] = {}
    lock = threading.Lock()

    def go(i: int, due: float) -> None:
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
        rec = stream_request(port, requests[i]["payload"], give_up_at)
        rec["due"], rec["index"] = due, i
        with lock:
            records[i] = rec

    threads = []
    if loop == "open":
        for i, r in enumerate(requests):
            due = start_at + r["due"]
            if due >= stop_at:
                break
            now = time.monotonic()
            if due - now > 0.002:
                time.sleep(due - now - 0.002)
            t = threading.Thread(target=go, args=(i, due), daemon=True)
            t.start()
            threads.append(t)
    else:
        nxt = [0]

        def client() -> None:
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                now = time.monotonic()
                if i >= len(requests) or now >= stop_at:
                    return
                go(i, max(now, start_at))

        now = time.monotonic()
        if start_at > now:
            time.sleep(start_at - now)
        for _ in range(clients):
            t = threading.Thread(target=client, daemon=True)
            t.start()
            threads.append(t)
    for t in threads:
        t.join(max(0.0, give_up_at - time.monotonic()) + 5.0)
    return [records[i] for i in sorted(records)]


def warm(port: int, payloads: list[dict], clients: int, give_up_at: float) -> int:
    """Warm-up requests, ``clients`` at a time, each hung up at its first
    audio; returns how many brought audio."""
    ok = []
    sem = threading.Semaphore(clients)

    def one(p):
        with sem:
            try:
                ok.append(cancelled_request(port, p, give_up_at))
            except OSError:
                ok.append(False)

    ts = [threading.Thread(target=one, args=(p,), daemon=True) for p in payloads]
    for t in ts:
        t.start()
    for t in ts:
        t.join(max(0.0, give_up_at - time.monotonic()) + 5.0)
    return sum(ok)


def hold(port: int, payloads: list[dict], give_up_at: float) -> list:
    """Streams kept open past their first audio (their rows keep their
    slots) until :func:`release`; a thread drains each."""
    held = []
    for p in payloads:
        body = json.dumps(p).encode()
        sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        sock.sendall(b"POST /tts HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        held.append(sock)
    for sock in held:
        got = 0
        while got <= 200 + WAV_HEADER:
            sock.settimeout(max(0.1, give_up_at - time.monotonic()))
            data = sock.recv(1 << 16)
            if not data:
                break
            got += len(data)

    def drain(sock):
        try:
            while sock.recv(1 << 16):
                pass
        except OSError:
            pass

    for sock in held:
        sock.settimeout(None)
        threading.Thread(target=drain, args=(sock,), daemon=True).start()
    return held


def release(held: list) -> None:
    for sock in held:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        sock.close()


def child_main(conn) -> None:
    """The child process's entry: serve the parent's commands (``warm``,
    ``hold``, ``release``, ``run``, ``quit``) one at a time, answering
    each."""
    held: list = []
    while True:
        cmd = conn.recv()
        if cmd["op"] == "hold":
            held += hold(cmd["port"], cmd["payloads"], cmd["give_up_at"])
            conn.send({"held": len(held)})
        elif cmd["op"] == "release":
            release(held)
            held = []
            conn.send({"released": True})
        elif cmd["op"] == "warm":
            conn.send({"warm_ok": warm(cmd["port"], cmd["payloads"], cmd["clients"],
                                       cmd["give_up_at"])})
        elif cmd["op"] == "run":
            conn.send({"records": run(cmd["port"], cmd["requests"], cmd["loop"], cmd["clients"],
                                      cmd["start_at"], cmd["stop_at"], cmd["give_up_at"])})
        else:
            release(held)
            conn.close()
            return
