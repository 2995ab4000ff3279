"""The load generator of the serving cells, a process of its own so that the
client's work never holds the server's interpreter lock. numpy and the
standard library only.

    python portbench/harness/loadgen.py --traffic <json> --seed <n>

It builds the run's upload pool (``traffic.py``), prints ``{"ready": ...}``
and then takes one JSON command a line on standard input, answering each
with one JSON line on standard output:

- ``{"cmd": "enroll", "port": p}``: every enrollment upload through
  ``/enroll``, ``enroll_concurrency`` at a time (a closed loop);
- ``{"cmd": "window", "port": p, "seconds": s}``: the open loop. Each
  request of :func:`traffic.schedule` is sent by a worker thread when it is
  due, whether or not earlier ones have been answered, and is timed from
  when it was due until its response has been read;
- ``{"cmd": "quit"}``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import traffic  # noqa: E402


def post(port: int, path: str, body: bytes, timeout: float):
    """(HTTP status or -1 where no response came, parsed JSON or None)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body, {"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        data = resp.read()
        try:
            return resp.status, json.loads(data)
        except ValueError:
            return resp.status, None
    except OSError:
        return -1, None
    finally:
        conn.close()


class LoadGenerator:
    def __init__(self, spec: dict, seed: int):
        self.spec, self.seed = spec, seed
        self.samples = traffic.pool_items(spec, seed)
        self.bodies = [traffic.wav_bytes(traffic.upload(seed, i, n))
                       for i, n in enumerate(self.samples)]

    def enroll(self, port: int) -> dict:
        todo = traffic.enrollments(self.spec)

        def one(job):
            speaker, item = job
            return post(port, f"/enroll?speaker={speaker}", self.bodies[item], 600.0)[0]

        with ThreadPoolExecutor(self.spec["enroll_concurrency"]) as ex:
            codes = list(ex.map(one, todo))
        return {"enrolled": sum(c == 200 for c in codes), "attempted": len(codes),
                "codes": sorted(set(codes))}

    def window(self, port: int, seconds: float) -> dict:
        plan = traffic.schedule(self.spec, self.seed, seconds)
        timeout = seconds + self.spec["drain_s"]
        records = [None] * len(plan)
        t0 = time.monotonic() + 0.05
        wall0 = time.time() + 0.05

        def one(k):
            due, item, speaker = plan[k]
            sent = time.monotonic() - t0
            status, body = post(port, f"/verify?speaker={speaker}", self.bodies[item],
                                max(1.0, timeout - sent))
            done = time.monotonic() - t0
            score = body.get("score") if status == 200 and body else None
            decision = body.get("decision") if status == 200 and body else None
            records[k] = [due, sent, done, status, score, decision, item, speaker]

        with ThreadPoolExecutor(self.spec["client_threads"]) as ex:
            for k, (due, _, _) in enumerate(plan):
                wait = t0 + due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                ex.submit(one, k)
        late = sorted(max(0.0, r[1] - r[0]) for r in records)
        return {"wall0": wall0, "records": records,
                "lateness_p99_ms": 1e3 * late[min(len(late) - 1, int(0.99 * len(late)))],
                "lateness_max_ms": 1e3 * late[-1]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traffic", required=True, help="the traffic's parameters as JSON")
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    t = time.perf_counter()
    gen = LoadGenerator(json.loads(args.traffic), args.seed)
    print(json.dumps({"ready": True, "build_s": time.perf_counter() - t,
                      "samples": gen.samples}), flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "quit":
            break
        if cmd["cmd"] == "enroll":
            out = gen.enroll(cmd["port"])
        else:
            out = gen.window(cmd["port"], cmd["seconds"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
