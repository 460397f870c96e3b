"""Continuous-batching websocket policy server (a copy of intact_tpu/serve/batching.py).

The per-request server answers one request at a time per connection. One
inference at batch 1 and at batch 64 cost nearly the same wall-clock on the
card (PERF.md), so this server keeps ONE model on the card and fuses
concurrent client requests into device-sized batches:

  connection handlers ──obs──> request queue ──collect(max_batch, timeout)──>
  group by fuse_key ──wrapper.infer_batch──> per-connection replies

The fuse itself lives with the policy wrapper (`infer_batch`, one
implementation per model family) — the server only collects, groups, and
scatters. Wire format is unchanged
(msgpack-numpy, metadata push, reset/switch_model control messages), so
reference evaluator clients drive it unmodified.

Shared-state semantics, pinned:
  * reset     — per-connection ONLY. It resets that connection's
    `PolicySession` (the env adapter's episode state). The shared policy is stateless across co-batched clients by
    construction (chunk sampling takes no episode state), so one client's
    reset can never clobber a neighbor mid-episode.
  * switch_model — global (one model on the card). It travels through the
    request queue as a control request, so ARRIVAL ORDER is authoritative:
    observations queued before the swap are answered by the old model,
    everything after by the new one; the load itself runs on the single
    device thread, serialized against in-flight infer_batch calls, so no
    sample ever sees half-swapped params.

`websockets` is imported by the methods that serve, so importing this module
needs only msgpack.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import os
import traceback

from intact_tpu_torch.protocol import msgpack_numpy
from intact_tpu_torch.utils.monitor import setup_logger


class _Request:
    __slots__ = ("inputs", "session", "future", "switch_path")

    def __init__(self, inputs, session, future, switch_path=None):
        self.inputs = inputs
        self.session = session
        self.future = future
        # non-None marks a switch_model CONTROL request: it travels through
        # the same queue as inference so arrival order is authoritative —
        # requests queued before it are answered by the old model, requests
        # after it by the new one (submitting the swap straight to the
        # device executor could overtake obs still waiting in the queue)
        self.switch_path = switch_path


class BatchingPolicyServer:
    def __init__(
        self,
        wrapper,  # BasePolicyWrapper: new_session/fuse_key/infer_batch/prewarm
        config,
        host: str = "0.0.0.0",
        port: int = 8000,
        metadata: dict | None = None,
        max_batch_size: int | None = None,
        batch_timeout_ms: float = 5.0,
        prewarm: bool = True,
    ):
        self._wrapper = wrapper
        self._config = config
        self._host = host
        self._port = port
        self._metadata = metadata or {}
        self._max_batch = max_batch_size or config.eval_cfg.max_batch_size
        self._timeout_s = batch_timeout_ms / 1000.0
        self._prewarm = prewarm
        self._queue: asyncio.Queue[_Request] = None  # created in run()
        # ONE device-work thread: inference and hot model swaps serialize on
        # it, so a switch_model never races an in-flight infer_batch
        # (the default executor has many threads and would interleave them)
        self._device_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="device"
        )
        # host-side preprocess (cv2 resize, normalization) runs OFF the
        # event loop so one connection's image work never stalls frame
        # handling for the others; per-connection ordering is preserved
        # because each handler awaits its own preprocess before queueing.
        # On hosts without real parallelism the hop is pure overhead, so it
        # only engages with 4 or more cores; INTACT_TPU_PREP_THREADS
        # overrides (0 = always inline).
        n_prep = os.environ.get("INTACT_TPU_PREP_THREADS")
        n_prep = int(n_prep) if n_prep is not None else (
            (os.cpu_count() or 1) if (os.cpu_count() or 1) >= 4 else 0
        )
        self._prep_executor = (
            concurrent.futures.ThreadPoolExecutor(
                max_workers=n_prep, thread_name_prefix="prep"
            )
            if n_prep > 0 else None
        )
        self.logger = setup_logger(True, name="batching_server")
        self.logger.setLevel(logging.INFO)

    def serve_forever(self) -> None:
        asyncio.run(self.run())

    async def run(self):
        import websockets.asyncio.server

        self._queue = asyncio.Queue()
        if self._prewarm:
            await asyncio.get_running_loop().run_in_executor(
                self._device_executor, self._wrapper.prewarm
            )
        worker = asyncio.create_task(self._batch_worker())
        try:
            async with websockets.asyncio.server.serve(
                self._handler, self._host, self._port,
                compression=None, max_size=None,
            ) as server:
                self.logger.info(
                    "batching server on %s:%s (max_batch=%d, timeout=%.1fms)",
                    self._host, self._port, self._max_batch, self._timeout_s * 1e3,
                )
                await server.serve_forever()
        finally:
            worker.cancel()

    # ------------------------------------------------------------------

    async def _batch_worker(self):
        """Collect requests into batches, group co-fusable requests (same
        fuse_key — a client sending odd shapes forms its own group instead of
        poisoning neighbors), and run the device once per group."""
        loop = asyncio.get_running_loop()
        n_batches = 0
        n_requests = 0
        while True:
            first = await self._queue.get()
            batch = [first]
            deadline = loop.time() + self._timeout_s
            while len(batch) < self._max_batch:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._queue.get(), remaining))
                except asyncio.TimeoutError:
                    break
            n_batches += 1
            n_requests += len(batch)
            if n_batches % 50 == 0:
                self.logger.info(
                    "batching: %d batches, mean fused size %.1f",
                    n_batches, n_requests / n_batches,
                )

            # split at switch_model control requests so arrival order holds:
            # infer everything queued before the swap with the old model,
            # swap, then infer what arrived after with the new one
            segment: list[_Request] = []
            for r in batch:
                if r.switch_path is None:
                    segment.append(r)
                    continue
                await self._run_segment(loop, segment)
                segment = []
                try:
                    await loop.run_in_executor(
                        self._device_executor,
                        self._wrapper.switch_model, r.switch_path,
                    )
                    if not r.future.done():
                        r.future.set_result({"status": "model switched"})
                except Exception as e:  # noqa: BLE001 — bad path / load error
                    if not r.future.done():
                        r.future.set_exception(e)
            await self._run_segment(loop, segment)

    async def _run_segment(self, loop, segment: list[_Request]):
        """Group co-fusable requests (same fuse_key — a client sending odd
        shapes forms its own group instead of poisoning neighbors) and run
        the device once per group."""
        if not segment:
            return
        groups: dict[object, list[_Request]] = {}
        for r in segment:
            try:
                key = self._wrapper.fuse_key(r.inputs)
            except Exception as e:  # noqa: BLE001 — malformed inputs
                if not r.future.done():
                    r.future.set_exception(e)
                continue
            groups.setdefault(key, []).append(r)

        for reqs in groups.values():
            try:
                results = await loop.run_in_executor(
                    self._device_executor,
                    self._wrapper.infer_batch,
                    [(r.inputs, r.session) for r in reqs],
                )
                if len(results) != len(reqs):
                    # a family fuse violating the N-in/N-out contract must
                    # surface as a group error — zip would silently skip the
                    # tail and leave those clients awaiting forever
                    raise RuntimeError(
                        f"infer_batch returned {len(results)} results for "
                        f"{len(reqs)} requests"
                    )
                # per-request outcomes: one client's bad input or failing
                # postprocess must not kill its co-batched neighbors'
                # episodes (the reference's per-request server only loses
                # the offending connection)
                for req, res in zip(reqs, results):
                    if req.future.done():
                        continue
                    if isinstance(res, Exception):
                        req.future.set_exception(res)
                    else:
                        req.future.set_result(res)
            except Exception as e:  # device-call failure: hits the group
                for req in reqs:
                    if not req.future.done():
                        req.future.set_exception(e)

    # ------------------------------------------------------------------

    async def _handler(self, websocket):
        import websockets
        import websockets.frames

        packer = msgpack_numpy.Packer()
        session = self._wrapper.new_session()  # per-connection episode state
        await websocket.send(packer.pack(self._metadata))
        loop = asyncio.get_running_loop()

        while True:
            try:
                obs = msgpack_numpy.unpackb(await websocket.recv())

                if isinstance(obs, dict) and obs.get("new_model_path") is not None:
                    # model swap is global to the shared policy. It travels
                    # through the request queue as a CONTROL request, so
                    # observations queued before it are answered by the old
                    # model and everything after by the new one; the worker
                    # runs the load on the single device thread, which also
                    # serializes it against in-flight infer_batch calls.
                    future = loop.create_future()
                    await self._queue.put(_Request(
                        None, session, future,
                        switch_path=obs["new_model_path"],
                    ))
                    await websocket.send(packer.pack(await future))
                    continue

                if isinstance(obs, dict) and obs.get("reset", False):
                    # per-connection only (see module docstring): co-batched
                    # clients' episodes and the shared policy are untouched
                    session.reset()
                    await websocket.send(packer.pack({"status": "reset"}))
                    continue

                if self._prep_executor is not None:
                    inputs = await loop.run_in_executor(
                        self._prep_executor, session.preprocess, obs
                    )
                else:
                    inputs = session.preprocess(obs)
                future = loop.create_future()
                await self._queue.put(_Request(inputs, session, future))
                action = await future
                await websocket.send(packer.pack(action))
            except websockets.ConnectionClosed:
                break
            except Exception:
                await websocket.send(traceback.format_exc())
                await websocket.close(
                    code=websockets.frames.CloseCode.INTERNAL_ERROR,
                    reason="Internal server error. Traceback included in previous frame.",
                )
                raise
