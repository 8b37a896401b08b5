"""The load generator: a process of its own, so that its clients take no
time from the server's interpreter. One asyncio loop, one connection a
request, HTTP/1.0 as the server speaks it.

    python benchmark/loadgen.py --mix <name> --seed <n> --seconds <s>

It draws the mix's requests (`traffic.requests`), encodes the images the
window can reach, prints {"ready": true}, and waits for `go <port>` on its
standard input. Then it runs the mix against http://127.0.0.1:<port>/v1/mmc:
a closed loop of `clients` callers that each send their next request when
the last one is answered, or an open loop that sends each request when it
is due. The window opens `ramp_s` seconds after the start (a closed loop
with `open_at`: when that request is sent) and lasts `--seconds`; a closed
loop with `close_on_block` closes instead when the first request of a
block (`block` requests from `open_at` on) is due to be sent at or after
`--seconds`, so that the window admits whole blocks, the same work in
every run. One JSON line a request reports its index, when it was due,
sent and answered (the monotonic clock, which the server's process shares),
its reply code and text; {"open": t} comes when the window opens,
{"window": [open, close]} when it closes, and {"closed": true} last. After
the close the closed loop stops at once; the open loop waits up to
`drain_s` for the requests due in the window.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
import uuid

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import traffic  # noqa: E402

DRAIN_S = 60.0


def emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def form(req: dict, images: dict) -> tuple:
    """(content type, body) of the request's multipart form."""
    text = " ".join(req["words"])
    prompt, files = [], {}
    if req["image"] is not None:
        prompt.append(["IMAGE", "img0"])
        files["img0"] = images[req["i"]]
    prompt.append(["TEXT", text])
    fields = {"log_id": f"r{req['i']}", "prompt": json.dumps(prompt),
              "max_new_tokens": str(req["new"]), "num_beams": "1"}
    boundary = uuid.uuid4().hex
    parts = []
    for k, v in fields.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{k}\"\r\n\r\n{v}\r\n".encode())
    for k, data in files.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{k}\"; filename=\"{k}.png\"\r\n"
                     f"Content-Type: image/png\r\n\r\n".encode()
                     + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return f"multipart/form-data; boundary={boundary}", b"".join(parts)


async def post(port: int, ctype: str, body: bytes) -> tuple:
    """(code, text) of one POST /v1/mmc; code -2 when the exchange
    itself failed."""
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        head = (f"POST /v1/mmc HTTP/1.0\r\nHost: 127.0.0.1\r\n"
                f"Content-Type: {ctype}\r\nContent-Length: {len(body)}"
                "\r\n\r\n").encode()
        writer.write(head + body)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        payload = json.loads(raw.split(b"\r\n\r\n", 1)[1])
        return int(payload["code"]), str(payload["data"])
    except (OSError, ValueError, IndexError, KeyError) as ex:
        return -2, f"exchange failed: {ex!r}"


async def run(mix: dict, reqs: list, images: dict, port: int,
              seconds: float) -> None:
    t_start = time.monotonic()
    t_open = t_start + float(mix.get("ramp_s", 0.0))
    t_close = t_open + seconds
    by_request = mix["loop"] == "closed" and "open_at" in mix
    if by_request:
        # the window opens when request `open_at` is sent, so that it
        # starts at the same point of the mix's sequence in every run (a
        # clock-timed open lands on either side of a burst of long
        # admissions, and the rate then reads in two modes)
        t_open = t_close = float("inf")

    async def one(req, due):
        sent = time.monotonic()
        code, text = await post(port, *form(req, images))
        emit({"i": req["i"], "due": due, "sent": sent,
              "done": time.monotonic(), "code": code, "text": text})

    if mix["loop"] == "closed":
        queue = iter(reqs)
        n = int(mix["clients"])
        on_block = by_request and bool(mix.get("close_on_block"))
        blk = int(mix.get("block", 1))
        opened, shut = asyncio.Event(), asyncio.Event()
        if not by_request:
            emit({"open": t_open})
            opened.set()

        async def client(k):
            nonlocal t_open, t_close
            # the clients join one by one over `stagger_s`, as a busy hour
            # builds up, rather than all at one instant
            await asyncio.sleep(k * float(mix.get("stagger_s", 0.0)) / n)
            while not shut.is_set():
                req = next(queue, None)
                if req is None:
                    emit({"exhausted": True})
                    shut.set()
                    return
                now = time.monotonic()
                if by_request and req["i"] == mix["open_at"]:
                    t_open = now
                    if not on_block:
                        t_close = t_open + seconds
                    emit({"open": t_open})
                    opened.set()
                elif on_block and now >= t_open + seconds and \
                        (req["i"] - mix["open_at"]) % blk == 0:
                    t_close = now
                    shut.set()
                    return
                elif now >= t_close:
                    return
                await one(req, now)

        tasks = [asyncio.create_task(client(k)) for k in range(n)]
        if on_block:
            await shut.wait()
        else:
            await opened.wait()
            await asyncio.sleep(max(0.0, t_close - time.monotonic()))
            shut.set()
        emit({"window": [t_open, t_close]})
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    else:
        # the schedule starts ramp_s before the window: dues are seconds
        # after t_start
        async def marks():
            await asyncio.sleep(max(0.0, t_open - time.monotonic()))
            emit({"open": t_open})
            await asyncio.sleep(max(0.0, t_close - time.monotonic()))
            emit({"window": [t_open, t_close]})
        mark = asyncio.create_task(marks())
        tasks = {}
        for req in reqs:
            due = t_start + req["due"]
            if due >= t_close:
                break
            await asyncio.sleep(max(0.0, due - time.monotonic()))
            tasks[asyncio.create_task(one(req, due))] = (req, due)
        if len(tasks) == len(reqs):
            emit({"exhausted": True})
        await mark
        pending = ()
        if tasks:
            _, pending = await asyncio.wait(tasks, timeout=max(
                0.1, t_close + DRAIN_S - time.monotonic()))
        for t in pending:
            # never answered: reported, so that it counts as missing
            t.cancel()
            req, due = tasks[t]
            emit({"i": req["i"], "due": due, "sent": due,
                  "done": float("inf"), "code": -3,
                  "text": "no answer within the drain"})
    emit({"closed": True})


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--mix", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rate", type=float, default=None,
                   help="an open loop's arrival rate in place of the mix's "
                        "(the knee sweep)")
    args = p.parse_args()
    mix = traffic.load_mix(args.mix)
    if args.rate is not None:
        mix["rate"] = args.rate
    reqs = traffic.requests(mix, args.seed)
    images = {}
    if mix.get("images", 0):
        w, h = mix["image_size"]
        horizon = float(mix["ramp_s"]) + args.seconds
        for req in reqs:
            if mix["loop"] == "open" and req["due"] > horizon:
                break
            if mix["loop"] == "closed" and len(images) >= mix["clients"] * 8:
                break
            images[req["i"]] = traffic.png(traffic.image(req["image"], w, h))
    emit({"ready": True})
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "go":
        return 2
    asyncio.run(run(mix, reqs, images, int(line[1]), args.seconds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
