"""Minimal rosbag1 (v2.0) reader/writer + Zenodo-style bag conversion.

The reference's primary benchmark dataset (Zenodo indoor/mixed,
the reference's ``README.md:5``) ships as ROS1 bags of
``sensor_msgs/PointCloud2`` radar scans plus ``sensor_msgs/Imu``
(``ndt_slam.cpp:94-209`` reads exactly those two topics in offline replay,
topics configured by ``ndt_radar_slam_base_parameters.yaml:1-8``).  This
module ingests such bags without any ROS dependency:

  * :func:`read_messages` — linear scan of a rosbag v2.0 file (chunked or
    chunkless; ``none``/``bz2`` chunk compression), yielding raw serialized
    messages with their connection metadata,
  * :func:`parse_pointcloud2` / :func:`parse_imu` — byte-level deserializers
    for the two message types the reference consumes,
  * :func:`convert_bag` — bag -> canonical ``.npz`` interchange sequence
    (the format ``randt_slam_torch.run --input seq.npz`` replays): point
    clouds are rasterized to polar intensity images by
    :func:`pack_polar_image`, IMU orientation is associated nearest-stamp
    per radar frame as ``imu_yaw``,
  * :func:`write_bag` — enough of a rosbag v2.0 WRITER (bag header + one
    uncompressed or bz2 chunk + index-free layout) to synthesize round-trip
    test fixtures and Zenodo-shaped e2e inputs.

Format reference: the public rosbag V2.0 specification (records of
length-prefixed ``name=value`` header fields + data blob; op codes 0x02
message, 0x03 bag header, 0x05 chunk, 0x07 connection).

A copy of ``randt_slam_tpu/io/rosbag.py`` (standard library and numpy; the
port imports nothing of the JAX package), held equal to it by
``tests/test_torch_io.py``.  ``pack_polar_image`` is the numpy version of
the JAX package's ``io/native.py`` helper, which the port does not bind.
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterator, NamedTuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"


class BagFormatError(ValueError):
    """Malformed / truncated rosbag input.

    The CLI surfaces this as a one-line error instead of a traceback
    (the reference consumer simply trusts ``rosbag::View``,
    ``ndt_slam.cpp:94-130``; first contact with real-world bags deserves
    better diagnostics)."""


OP_MSG = 0x02
OP_BAG = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


# ---------------------------------------------------------------------------
# low-level record plumbing
# ---------------------------------------------------------------------------


def _parse_fields(buf: bytes) -> dict:
    """Length-prefixed ``name=value`` field set (record headers and
    connection data blocks share this encoding)."""
    fields = {}
    off = 0
    while off < len(buf):
        if off + 4 > len(buf):
            raise BagFormatError("truncated field-set (length prefix cut)")
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + n > len(buf):
            raise BagFormatError(
                f"truncated field-set (field of {n} bytes past end)")
        item = buf[off:off + n]
        off += n
        eq = item.find(b"=")
        if eq < 0:
            raise BagFormatError(
                f"malformed header field (no '='): {item[:40]!r}")
        fields[item[:eq].decode(errors="replace")] = item[eq + 1:]
    return fields


def _encode_fields(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        if isinstance(v, str):
            v = v.encode()
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _iter_records(buf: bytes, off: int = 0) -> Iterator[tuple[dict, bytes]]:
    end = len(buf)
    while off < end:
        if off + 4 > end:
            raise BagFormatError("truncated record (header length cut)")
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + hlen > end:
            raise BagFormatError(
                f"truncated record (header of {hlen} bytes past end)")
        header = _parse_fields(buf[off:off + hlen])
        off += hlen
        if off + 4 > end:
            raise BagFormatError("truncated record (data length cut)")
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        if off + dlen > end:
            raise BagFormatError(
                f"truncated record (data of {dlen} bytes past end)")
        data = buf[off:off + dlen]
        off += dlen
        if "op" not in header or len(header["op"]) != 1:
            raise BagFormatError("record without a valid 'op' header field")
        yield header, data


class BagMessage(NamedTuple):
    topic: str
    msg_type: str       # e.g. 'sensor_msgs/PointCloud2'
    stamp: float        # record receive time [s]
    raw: bytes          # serialized message body


def read_messages(path: str) -> Iterator[BagMessage]:
    """Linear scan of a rosbag v2.0 file — no index needed (the reference's
    offline mode also walks the bag front to back, ``ndt_slam.cpp:101-130``).

    Raises :class:`BagFormatError` on truncated / malformed input instead of
    leaking ``struct.error`` / ``KeyError`` to the caller.
    """
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_MAGIC):
        raise BagFormatError(f"{path}: not a rosbag v2.0 file")
    connections: dict[int, tuple[str, str]] = {}

    def _u32(header, key):
        v = header.get(key)
        if v is None or len(v) != 4:
            raise BagFormatError(f"record missing/short '{key}' field")
        return struct.unpack("<I", v)[0]

    def handle(header: dict, data: bytes):
        op = header["op"][0]
        if op == OP_CONNECTION:
            conn = _u32(header, "conn")
            info = _parse_fields(data)
            if "topic" not in header or "type" not in info:
                raise BagFormatError("connection record missing topic/type")
            connections[conn] = (header["topic"].decode(errors="replace"),
                                 info["type"].decode(errors="replace"))
        elif op == OP_MSG:
            conn = _u32(header, "conn")
            t = header.get("time")
            if t is None or len(t) != 8:
                raise BagFormatError("message record missing/short 'time'")
            secs, nsecs = struct.unpack("<II", t)
            topic, mtype = connections.get(conn, ("?", "?"))
            return BagMessage(topic, mtype, secs + 1e-9 * nsecs, data)
        return None

    for header, data in _iter_records(blob, len(_MAGIC)):
        op = header["op"][0]
        if op == OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "none":
                payload = data
            elif comp == "bz2":
                try:
                    payload = bz2.decompress(data)
                except (OSError, ValueError, EOFError) as e:
                    # CPython raises ValueError for a stream cut mid-chunk
                    # and OSError for garbage bytes — both are corrupt input
                    raise BagFormatError(
                        f"corrupt bz2 chunk: {e}") from e
            else:
                raise NotImplementedError(
                    f"chunk compression '{comp}' (only none/bz2 here; "
                    "re-record or decompress the bag)")
            for h2, d2 in _iter_records(payload):
                m = handle(h2, d2)
                if m is not None:
                    yield m
        elif op in (OP_CONNECTION, OP_MSG):
            m = handle(header, data)
            if m is not None:
                yield m
        # OP_BAG / OP_INDEX / OP_CHUNK_INFO: bookkeeping only


# ---------------------------------------------------------------------------
# message deserialization (byte-exact ROS1 serialization)
# ---------------------------------------------------------------------------

_PC2_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
               5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


class PointCloud2(NamedTuple):
    stamp: float
    frame_id: str
    points_xyi: np.ndarray   # (n, 3) float32 [x, y, intensity]


class ImuSample(NamedTuple):
    stamp: float
    quat_xyzw: np.ndarray    # (4,) float64 orientation
    yaw: float               # extracted z-rotation [rad]


def _need(raw: bytes, off: int, n: int, what: str):
    if off + n > len(raw):
        raise BagFormatError(f"truncated message ({what} past end)")


def _read_header(buf: bytes, off: int) -> tuple[float, str, int]:
    _need(buf, off, 16, "std_msgs/Header")
    _, secs, nsecs, n = struct.unpack_from("<IIII", buf, off)
    off += 16
    _need(buf, off, n, "frame_id string")
    frame_id = buf[off:off + n].decode(errors="replace")
    off += n
    return secs + 1e-9 * nsecs, frame_id, off


def parse_pointcloud2(raw: bytes) -> PointCloud2:
    """Deserialize ``sensor_msgs/PointCloud2``; extracts x, y, intensity
    (the fields the reference's preprocessor consumes,
    ``radar_preprocessor.cpp:45-125``).  Handles row-padded layouts
    (``row_step > point_step * width``) and big-endian fields; raises
    :class:`BagFormatError` on truncation / unknown dtypes / missing x-y."""
    stamp, frame_id, off = _read_header(raw, 0)
    _need(raw, off, 12, "PointCloud2 dims")
    height, width, n_fields = struct.unpack_from("<III", raw, off)
    off += 12
    if n_fields > 256:
        raise BagFormatError(f"implausible PointCloud2 field count "
                             f"{n_fields}")
    fields = []
    for _ in range(n_fields):
        _need(raw, off, 4, "PointField name length")
        (n,) = struct.unpack_from("<I", raw, off)
        off += 4
        _need(raw, off, n + 9, "PointField")
        name = raw[off:off + n].decode(errors="replace")
        off += n
        f_off, dtype, count = struct.unpack_from("<IBI", raw, off)
        off += 9
        fields.append((name, f_off, dtype, count))
    _need(raw, off, 9 + 4, "PointCloud2 layout")
    is_bigendian, point_step, row_step = struct.unpack_from("<BII", raw, off)
    off += 9
    (dlen,) = struct.unpack_from("<I", raw, off)
    off += 4
    _need(raw, off, dlen, "PointCloud2 data blob")
    if point_step == 0:
        raise BagFormatError("PointCloud2 with point_step=0")
    data = np.frombuffer(raw, np.uint8, dlen, off)
    n_pts = height * width
    if row_step != point_step * width:  # row padding: gather dense rows
        if row_step < point_step * width or dlen < row_step * height:
            raise BagFormatError(
                f"PointCloud2 row layout inconsistent (row_step {row_step}, "
                f"point_step {point_step}, width {width}, data {dlen})")
        data = np.concatenate([
            data[r * row_step: r * row_step + point_step * width]
            for r in range(height)])
    if len(data) < n_pts * point_step:
        raise BagFormatError(
            f"PointCloud2 data short: {len(data)} bytes for "
            f"{n_pts} x {point_step}")
    recs = data[:n_pts * point_step].reshape(n_pts, point_step)
    by_name = {f[0]: f for f in fields}
    for req in ("x", "y"):
        if req not in by_name:
            raise BagFormatError(
                f"PointCloud2 missing required field '{req}' "
                f"(has {sorted(by_name)})")

    def col(name):
        _, f_off, dtype, _ = by_name[name]
        if dtype not in _PC2_DTYPES:
            raise BagFormatError(
                f"PointCloud2 field '{name}' has unknown dtype {dtype}")
        dt = np.dtype(_PC2_DTYPES[dtype])
        if f_off + dt.itemsize > point_step:
            raise BagFormatError(
                f"PointCloud2 field '{name}' overruns point_step")
        if is_bigendian:
            dt = dt.newbyteorder(">")
        raw_col = np.ascontiguousarray(recs[:, f_off:f_off + dt.itemsize])
        return raw_col.view(dt).reshape(-1).astype(np.float32)

    x = col("x")
    y = col("y")
    inten = col("intensity") if "intensity" in by_name else np.ones(
        n_pts, np.float32)
    return PointCloud2(stamp, frame_id,
                       np.stack([x, y, inten], axis=1))


def parse_imu(raw: bytes) -> ImuSample:
    """Deserialize ``sensor_msgs/Imu``; the reference uses only the
    orientation quaternion (relative yaw between frames,
    ``local_fuser.cpp:110-120``)."""
    stamp, _, off = _read_header(raw, 0)
    _need(raw, off, 32, "Imu quaternion")
    q = np.frombuffer(raw, np.float64, 4, off)  # x, y, z, w
    x, y, z, w = q
    yaw = np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return ImuSample(stamp, q.copy(), float(yaw))


# ---------------------------------------------------------------------------
# message serialization + bag writing (test fixtures / synthetic bags)
# ---------------------------------------------------------------------------


def serialize_pointcloud2(points_xyi, stamp: float,
                          frame_id: str = "radar") -> bytes:
    pts = np.ascontiguousarray(points_xyi, np.float32)
    n = pts.shape[0]
    secs, nsecs = int(stamp), int(round((stamp % 1.0) * 1e9))
    out = struct.pack("<IIII", 0, secs, nsecs, len(frame_id))
    out += frame_id.encode()
    out += struct.pack("<III", 1, n, 3)          # height=1, width=n, 3 fields
    for name, f_off in (("x", 0), ("y", 4), ("intensity", 8)):
        out += struct.pack("<I", len(name)) + name.encode()
        out += struct.pack("<IBI", f_off, 7, 1)  # offset, FLOAT32, count
    out += struct.pack("<BII", 0, 12, 12 * n)    # le, point_step, row_step
    body = pts.tobytes()
    out += struct.pack("<I", len(body)) + body
    out += struct.pack("<B", 1)                  # is_dense
    return out


def serialize_imu(yaw: float, stamp: float, frame_id: str = "imu") -> bytes:
    secs, nsecs = int(stamp), int(round((stamp % 1.0) * 1e9))
    out = struct.pack("<IIII", 0, secs, nsecs, len(frame_id))
    out += frame_id.encode()
    q = np.array([0.0, 0.0, np.sin(yaw / 2.0), np.cos(yaw / 2.0)], np.float64)
    out += q.tobytes()
    out += np.zeros(9, np.float64).tobytes()     # orientation covariance
    out += np.zeros(3 + 9 + 3 + 9, np.float64).tobytes()
    return out


def write_bag(path: str, messages, compression: str = "none"):
    """Write (topic, msg_type, stamp, raw) tuples as one rosbag v2.0 chunk.

    Index-free: readable by :func:`read_messages` (linear scan); not meant
    for rosbag-API random access."""
    topics = {}
    records = b""
    for topic, mtype, stamp, raw in messages:
        if topic not in topics:
            conn = len(topics)
            topics[topic] = conn
            hdr = _encode_fields({"op": bytes([OP_CONNECTION]),
                                  "conn": struct.pack("<I", conn),
                                  "topic": topic})
            data = _encode_fields({"topic": topic, "type": mtype,
                                   "md5sum": "*", "message_definition": ""})
            records += struct.pack("<I", len(hdr)) + hdr
            records += struct.pack("<I", len(data)) + data
        hdr = _encode_fields({
            "op": bytes([OP_MSG]),
            "conn": struct.pack("<I", topics[topic]),
            "time": struct.pack("<II", int(stamp),
                                int(round((stamp % 1.0) * 1e9))),
        })
        records += struct.pack("<I", len(hdr)) + hdr
        records += struct.pack("<I", len(raw)) + raw

    payload = records if compression == "none" else bz2.compress(records)
    chunk_hdr = _encode_fields({"op": bytes([OP_CHUNK]),
                                "compression": compression,
                                "size": struct.pack("<I", len(records))})
    bag_hdr = _encode_fields({"op": bytes([OP_BAG]),
                              "index_pos": struct.pack("<Q", 0),
                              "conn_count": struct.pack("<I", len(topics)),
                              "chunk_count": struct.pack("<I", 1)})
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(bag_hdr)) + bag_hdr)
        f.write(struct.pack("<I", 4096 - len(bag_hdr)) + b" " * (
            4096 - len(bag_hdr)))  # rosbag pads its header record
        f.write(struct.pack("<I", len(chunk_hdr)) + chunk_hdr)
        f.write(struct.pack("<I", len(payload)) + payload)


# ---------------------------------------------------------------------------
# bag -> npz conversion
# ---------------------------------------------------------------------------


def pack_polar_image(points_xyi, azimuth0, azimuth_step, n_azimuths,
                     r0, bin_width, n_bins):
    """(n, 3) float32 [x, y, intensity] -> (A, R) float32 polar image:
    azimuth rows ``azimuth0 + k * azimuth_step`` (wrapping), range bins
    ``r0 + j * bin_width``, intensities max-combined per bin.

    The arithmetic of the JAX package's native ``pack_polar_image``
    (``native/randt_native.cpp``), in float32: the azimuth position is
    wrapped into one turn and rounded half away from zero (``lround``; after
    the wrap it is non-negative, so ``floor(rel + 0.5)``, taken in float64
    where the sum is exact), and a bin takes an intensity only when it is
    greater than the bin's value, so NaN and non-positive intensities are
    never written.  The azimuth is the float64 ``arctan2`` rounded to
    float32, within an ulp of the C library's ``atan2f`` (numpy's float32
    ``arctan2`` puts the point (1, 1) an ulp below pi / 4)."""
    f32 = np.float32
    pts = np.ascontiguousarray(points_xyi, f32)
    out = np.zeros((n_azimuths, n_bins), f32)
    r = np.hypot(pts[:, 0], pts[:, 1])
    a = np.arctan2(pts[:, 1].astype(np.float64),
                   pts[:, 0].astype(np.float64)).astype(f32)
    step = f32(azimuth_step)
    turn = f32(2 * np.pi) / step
    rel = (a - f32(azimuth0)) / step
    rel = rel - np.floor(rel / turn) * turn
    ai = np.floor(rel.astype(np.float64) + 0.5).astype(np.int64) % n_azimuths
    ri = np.floor((r - f32(r0)) / f32(bin_width)).astype(np.int64)
    inten = pts[:, 2]
    ok = (ri >= 0) & (ri < n_bins) & (inten > 0)
    np.maximum.at(out, (ai[ok], ri[ok]), inten[ok])
    return out


def convert_bag(bag_path: str, out_npz: str,
                radar_topic: str | None = None,
                imu_topic: str | None = None,
                n_azimuths: int = 400, n_bins: int = 512,
                max_range: float | None = None,
                max_frames: int | None = None) -> dict:
    """Bag -> canonical ``.npz`` sequence (BASELINE configs 1-2 ingestion).

    Each ``PointCloud2`` becomes one polar intensity frame via
    ``pack_polar_image``; IMU yaw is nearest-stamp-associated per frame.
    Topics default to the first PointCloud2 / Imu connection seen (the
    Zenodo bags carry one of each, per the base config's
    ``radar_topic: /radar_data`` / ``imu_topic: /imu/data``).
    Returns a summary dict (frames, topics, time span).
    """
    clouds = []
    imu = []
    for m in read_messages(bag_path):
        if m.msg_type.endswith("PointCloud2") and (
                radar_topic is None or m.topic == radar_topic):
            radar_topic = radar_topic or m.topic
            if max_frames is None or len(clouds) < max_frames:
                clouds.append(parse_pointcloud2(m.raw))
        elif m.msg_type.endswith("Imu") and (
                imu_topic is None or m.topic == imu_topic):
            imu_topic = imu_topic or m.topic
            imu.append(parse_imu(m.raw))
    if not clouds:
        raise ValueError(f"{bag_path}: no PointCloud2 messages"
                         f"{' on ' + radar_topic if radar_topic else ''}")

    if max_range is None:
        max_range = max(float(np.hypot(c.points_xyi[:, 0],
                                       c.points_xyi[:, 1]).max())
                        for c in clouds if len(c.points_xyi))
        max_range = float(np.ceil(max_range))
    bin_w = max_range / n_bins
    az0 = -np.pi
    az_step = 2.0 * np.pi / n_azimuths

    frames = np.zeros((len(clouds), n_azimuths, n_bins), np.float32)
    for t, c in enumerate(clouds):
        frames[t] = pack_polar_image(
            c.points_xyi, az0, az_step, n_azimuths, 0.0, bin_w, n_bins)
    stamps = np.asarray([c.stamp for c in clouds], np.float64)

    payload = dict(
        intensity=frames.astype(np.float16),
        azimuths=(az0 + az_step * np.arange(n_azimuths)).astype(np.float32),
        ranges=((np.arange(n_bins) + 0.5) * bin_w).astype(np.float32),
        stamps=stamps,
    )
    if imu:
        im_st = np.asarray([s.stamp for s in imu])
        im_yaw = np.unwrap(np.asarray([s.yaw for s in imu]))
        idx = np.clip(np.searchsorted(im_st, stamps), 0, len(imu) - 1)
        payload["imu_yaw"] = im_yaw[idx].astype(np.float32)
    np.savez_compressed(out_npz, **payload)
    return {
        "frames": len(clouds), "imu_samples": len(imu),
        "radar_topic": radar_topic, "imu_topic": imu_topic,
        "span_s": float(stamps[-1] - stamps[0]) if len(stamps) > 1 else 0.0,
        "max_range": max_range, "out": out_npz,
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Convert a ROS1 bag (PointCloud2 + Imu) to the .npz "
                    "sequence format consumed by randt_slam_torch.run")
    ap.add_argument("bag")
    ap.add_argument("out_npz")
    ap.add_argument("--radar-topic", default=None)
    ap.add_argument("--imu-topic", default=None)
    ap.add_argument("--azimuths", type=int, default=400)
    ap.add_argument("--bins", type=int, default=512)
    ap.add_argument("--max-range", type=float, default=None)
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args(argv)
    try:
        info = convert_bag(args.bag, args.out_npz,
                           radar_topic=args.radar_topic,
                           imu_topic=args.imu_topic,
                           n_azimuths=args.azimuths, n_bins=args.bins,
                           max_range=args.max_range, max_frames=args.frames)
    except (BagFormatError, NotImplementedError, FileNotFoundError,
            ValueError) as e:
        # malformed input is a user error, not a crash: one line, exit 2
        import sys as _sys

        print(f"error: {e}", file=_sys.stderr)
        raise SystemExit(2)
    print(json.dumps(info))


if __name__ == "__main__":
    main()
