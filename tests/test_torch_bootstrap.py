"""A peer that resets its connection must not leave the event loop a
selector key for a closed fd: the next socket that gets that fd number
would then never read (a worker's bootstrap ``get_all_nodes`` timing out
after 60 s, with an asyncio ``_add_reader(fd, ...)`` raising
FileNotFoundError from epoll's modify).

Python 3.12's ``_SelectorSocketTransport.writelines`` has no check that
the connection is lost: between a fatal send error (the peer reset the
connection) and the transport's deferred ``_call_connection_lost`` it
queues the bytes and registers a writer for the fd, which the socket's
close then leaves behind. ``rpc.Connection`` never hands bytes to a
closing transport. The test drives that window the way a head meets it:
a peer resets its connection, and the next two sends to it run back to
back (a small frame flushed first, then a large frame's buffers)."""

import asyncio
import socket
import struct
import time

from ray_tpu_torch._internal import rpc


async def _stale_key_after_reset(rpc):
    loop = asyncio.get_running_loop()
    errors = []
    loop.set_exception_handler(lambda _loop, ctx: errors.append(ctx))
    server = rpc.RpcServer({"echo": lambda conn, arg: arg})
    port = await server.start()
    client = await rpc.connect("127.0.0.1", port)
    assert await client.call("echo", 1, timeout=5) == 1
    (sconn,) = server.connections
    fd = sconn.writer.get_extra_info("socket").fileno()
    # the peer resets: close with SO_LINGER 0 sends an RST
    client.writer.get_extra_info("socket").setsockopt(
        socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    client.writer.transport.abort()
    await asyncio.sleep(0)        # the client's socket closes
    time.sleep(0.05)              # the RST reaches the server's socket
    # back to back, before the loop reads the reset: the first send fails
    # and loses the connection, the second (a large frame's buffers)
    # meets a transport that is closing
    sconn._send_frames([b"\0" * 16])
    sconn._flush_wbuf()
    sconn._send_frames([b"\0" * 16, b"\0" * 16])
    for _ in range(5):
        await asyncio.sleep(0.01)  # the transport closes its socket
    stale = fd in loop._selector.get_map()
    # the next socket gets the same fd number: it must still read
    again = await rpc.connect("127.0.0.1", port)
    try:
        answer = await again.call("echo", 2, timeout=5)
    except rpc.RpcError as e:
        answer = e
    await again.close()
    await server.stop()
    return stale, answer, [c.get("exception") for c in errors]


def test_reset_peer_leaves_no_selector_key():
    stale, answer, errors = asyncio.run(_stale_key_after_reset(rpc))
    assert not stale
    assert answer == 2
    assert not [e for e in errors if isinstance(e, FileNotFoundError)]


def test_the_reference_keeps_the_stale_key():
    """The reference's Connection writes to the closing transport: the
    same window leaves the key. (Whether the next connection then gets
    that fd number depends on what else the process opened meanwhile;
    alone, it does, and never reads its reply.)"""
    from ray_tpu._internal import rpc as jrpc

    stale, _, _ = asyncio.run(_stale_key_after_reset(jrpc))
    assert stale


def test_loop_errors_name_the_process():
    """An exception a loop callback raises is logged with the pid of the
    process whose loop it is."""
    import logging
    import os

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("ray_tpu_torch.rpc").addHandler(handler)
    loop_thread = rpc.EventLoopThread("rayt-io-test")
    try:
        loop_thread.loop.call_soon_threadsafe(
            lambda: (_ for _ in ()).throw(FileNotFoundError(2, "x")))
        loop_thread.run(asyncio.sleep(0.05), timeout=5)
    finally:
        loop_thread.stop()
        logging.getLogger("ray_tpu_torch.rpc").removeHandler(handler)
    (record,) = [r for r in records
                 if "event loop error" in r.getMessage()]
    assert f"pid {os.getpid()}" in record.getMessage()
    assert isinstance(record.exc_info[1], FileNotFoundError)
