"""Standalone ROS1 bag (format 2.0) reader/writer, no ROS runtime needed.

Counterpart of ``mlis_tpu/core/bag.py``, kept as the port's own copy: bag
records -> chunks (none/bz2/lz4 compression) -> connection + message
records, decoders and encoders for the message types the NUFR-M3F pipeline
touches (sensor_msgs/Imu, sensor_msgs/PointCloud2, sensor_msgs/Image,
nav_msgs/Odometry), and batch extraction paths that hand blob offsets to
the port's native C++ decodes (``runtime/native.py``). Everything here is
host code: the arrays it returns are numpy, handed to the floor detector
and the LiDAR tracker, which move them to the device.

The reader holds the whole bag in memory, as the JAX package's does; the
writer holds every record until ``close``.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MESSAGE = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _pack_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        entry = k + b"=" + v
        out += struct.pack("<I", len(entry)) + entry
    return out


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    i = 0
    while i < len(buf):
        (ln,) = struct.unpack_from("<I", buf, i)
        i += 4
        entry = buf[i : i + ln]
        i += ln
        k, _, v = entry.partition(b"=")
        fields[k] = v
    return fields


def _time_bytes(t: float) -> bytes:
    sec = int(t)
    nsec = int(round((t - sec) * 1e9))
    return struct.pack("<II", sec, nsec)


@dataclass
class Connection:
    conn_id: int
    topic: str
    datatype: str = ""
    md5sum: str = ""


@dataclass
class BagMessage:
    topic: str
    datatype: str
    timestamp: float  # bag receive time (seconds)
    data: bytes  # serialized message body


class BagReader:
    """Linear chunk-scanning reader (indexes ignored — robust and simple)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.connections: Dict[int, Connection] = {}
        with open(self.path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path} is not a ROS bag v2.0")

    def _records(self, buf: bytes) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
        i = 0
        n = len(buf)
        while i + 8 <= n:
            (hlen,) = struct.unpack_from("<I", buf, i)
            header = _parse_header(buf[i + 4 : i + 4 + hlen])
            i += 4 + hlen
            (dlen,) = struct.unpack_from("<I", buf, i)
            data = buf[i + 4 : i + 4 + dlen]
            i += 4 + dlen
            yield header, data

    def _register_connection(self, header: Dict[bytes, bytes], data: bytes):
        cid = struct.unpack("<I", header[b"conn"])[0]
        topic = header.get(b"topic", b"").decode()
        sub = _parse_header(data)
        self.connections[cid] = Connection(
            conn_id=cid,
            topic=topic or sub.get(b"topic", b"").decode(),
            datatype=sub.get(b"type", b"").decode(),
            md5sum=sub.get(b"md5sum", b"").decode(),
        )

    def read_messages(
        self, topics: Optional[Sequence[str]] = None
    ) -> Iterator[BagMessage]:
        want = set(topics) if topics else None
        blob = self.path.read_bytes()[len(MAGIC) :]
        for header, data in self._records(blob):
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                self._register_connection(header, data)
            elif op == OP_CHUNK:
                compression = header.get(b"compression", b"none").decode()
                if compression == "none":
                    chunk = data
                elif compression == "bz2":
                    chunk = bz2.decompress(data)
                elif compression == "lz4":
                    # rosbag's roslz4 writes standard LZ4 frames
                    from mlis_tpu_torch.core import lz4f

                    chunk = lz4f.decompress(data)
                else:
                    raise NotImplementedError(
                        f"bag compression {compression!r} not supported"
                    )
                for h2, d2 in self._records(chunk):
                    op2 = h2.get(b"op", b"\x00")[0]
                    if op2 == OP_CONNECTION:
                        self._register_connection(h2, d2)
                    elif op2 == OP_MESSAGE:
                        cid = struct.unpack("<I", h2[b"conn"])[0]
                        conn = self.connections.get(cid)
                        if conn is None:
                            continue
                        if want and conn.topic not in want:
                            continue
                        sec, nsec = struct.unpack("<II", h2[b"time"])
                        yield BagMessage(
                            topic=conn.topic,
                            datatype=conn.datatype,
                            timestamp=sec + 1e-9 * nsec,
                            data=d2,
                        )

    # -- info (bag_utils.BagInfo equivalent) ----------------------------------
    def info(self) -> Dict:
        counts: Dict[str, int] = {}
        t0, t1 = None, None
        for msg in self.read_messages():
            counts[msg.topic] = counts.get(msg.topic, 0) + 1
            t0 = msg.timestamp if t0 is None else min(t0, msg.timestamp)
            t1 = msg.timestamp if t1 is None else max(t1, msg.timestamp)
        return {
            "path": str(self.path),
            "topics": {
                c.topic: c.datatype for c in self.connections.values()
            },
            "message_counts": counts,
            "start": t0,
            "end": t1,
            "duration": (t1 - t0) if (t0 is not None and t1 is not None) else 0.0,
        }


class BagWriter:
    """Minimal uncompressed-bag writer (one chunk) for tests/tooling."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._conns: Dict[str, int] = {}
        self._conn_records: List[bytes] = []
        self._msg_records: List[bytes] = []

    def _connection(self, topic: str, datatype: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        sub = _pack_header(
            {
                b"topic": topic.encode(),
                b"type": datatype.encode(),
                b"md5sum": b"0" * 32,
                b"message_definition": b"",
            }
        )
        header = _pack_header(
            {
                b"op": bytes([OP_CONNECTION]),
                b"conn": struct.pack("<I", cid),
                b"topic": topic.encode(),
            }
        )
        rec = struct.pack("<I", len(header)) + header + struct.pack("<I", len(sub)) + sub
        self._conn_records.append(rec)
        return cid

    def write(self, topic: str, datatype: str, timestamp: float, data: bytes):
        cid = self._connection(topic, datatype)
        header = _pack_header(
            {
                b"op": bytes([OP_MESSAGE]),
                b"conn": struct.pack("<I", cid),
                b"time": _time_bytes(timestamp),
            }
        )
        self._msg_records.append(
            struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data
        )

    def close(self, compression: str = "none"):
        chunk = b"".join(self._conn_records + self._msg_records)
        raw_len = len(chunk)
        if compression == "bz2":
            chunk = bz2.compress(chunk)
        elif compression == "lz4":
            from mlis_tpu_torch.core import lz4f

            chunk = lz4f.compress(chunk)
        chunk_header = _pack_header(
            {
                b"op": bytes([OP_CHUNK]),
                b"compression": compression.encode(),
                b"size": struct.pack("<I", raw_len),
            }
        )
        bag_header = _pack_header(
            {
                b"op": bytes([OP_BAG_HEADER]),
                b"index_pos": struct.pack("<Q", 0),
                b"conn_count": struct.pack("<I", len(self._conns)),
                b"chunk_count": struct.pack("<I", 1),
            }
        )
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<I", len(bag_header)) + bag_header)
            # bag header records are padded to 4096 bytes in real bags; a
            # zero-length data section keeps parsers happy here
            f.write(struct.pack("<I", 0))
            f.write(struct.pack("<I", len(chunk_header)) + chunk_header)
            f.write(struct.pack("<I", len(chunk)) + chunk)


# -- message (de)serialization ---------------------------------------------------


def _read_header_stamp(data: bytes) -> Tuple[float, int]:
    sec, nsec, fid = struct.unpack_from("<III", data, 4)
    return sec + 1e-9 * nsec, 16 + fid


def decode_imu(data: bytes):
    """sensor_msgs/Imu -> (stamp, accel (3,), gyro (3,), orientation (4,))."""
    stamp, base = _read_header_stamp(data)
    orientation = np.frombuffer(data, np.float64, 4, base)
    gyro = np.frombuffer(data, np.float64, 3, base + 104)
    accel = np.frombuffer(data, np.float64, 3, base + 104 + 96)
    return stamp, accel, gyro, orientation


def encode_imu(stamp: float, accel, gyro, orientation=(0, 0, 0, 1), frame_id=b"imu"):
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    out = struct.pack("<IIII", 0, sec, nsec, len(frame_id)) + frame_id
    out += np.asarray(orientation, np.float64).tobytes()
    out += np.zeros(9, np.float64).tobytes()
    out += np.asarray(gyro, np.float64).tobytes()
    out += np.zeros(9, np.float64).tobytes()
    out += np.asarray(accel, np.float64).tobytes()
    out += np.zeros(9, np.float64).tobytes()
    return out


def decode_odometry(data: bytes):
    """nav_msgs/Odometry -> (stamp, position (3,), quaternion xyzw (4,))."""
    stamp, base = _read_header_stamp(data)
    (cid,) = struct.unpack_from("<I", data, base)
    base += 4 + cid
    pose = np.frombuffer(data, np.float64, 7, base)
    return stamp, pose[:3], pose[3:]


def encode_odometry(stamp, position, quaternion, frame_id=b"odom", child=b"base"):
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    out = struct.pack("<IIII", 0, sec, nsec, len(frame_id)) + frame_id
    out += struct.pack("<I", len(child)) + child
    out += np.asarray(position, np.float64).tobytes()
    out += np.asarray(quaternion, np.float64).tobytes()
    out += np.zeros(36, np.float64).tobytes()  # pose covariance
    out += np.zeros(6, np.float64).tobytes()  # twist
    out += np.zeros(36, np.float64).tobytes()  # twist covariance
    return out


@dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


def decode_pointcloud2(data: bytes):
    """sensor_msgs/PointCloud2 -> (stamp, fields, point_step, blob)."""
    stamp, base = _read_header_stamp(data)
    height, width = struct.unpack_from("<II", data, base)
    base += 8
    (n_fields,) = struct.unpack_from("<I", data, base)
    base += 4
    fields = []
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<I", data, base)
        base += 4
        name = data[base : base + nlen].decode()
        base += nlen
        off, dtype, count = struct.unpack_from("<IBI", data, base)
        base += 9
        fields.append(PointField(name, off, dtype, count))
    base += 1  # is_bigendian
    point_step, row_step = struct.unpack_from("<II", data, base)
    base += 8
    (blob_len,) = struct.unpack_from("<I", data, base)
    base += 4
    blob = data[base : base + blob_len]
    return stamp, fields, point_step, blob


def encode_pointcloud2(
    stamp: float,
    blob: bytes,
    point_step: int,
    fields: Sequence[PointField],
    frame_id=b"os_sensor",
):
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    n = len(blob) // point_step
    out = struct.pack("<IIII", 0, sec, nsec, len(frame_id)) + frame_id
    out += struct.pack("<II", 1, n)  # height=1, width=n
    out += struct.pack("<I", len(fields))
    for f in fields:
        nm = f.name.encode()
        out += struct.pack("<I", len(nm)) + nm
        out += struct.pack("<IBI", f.offset, f.datatype, f.count)
    out += b"\x00"  # little-endian
    out += struct.pack("<II", point_step, len(blob))
    out += struct.pack("<I", len(blob)) + blob
    out += b"\x01"  # is_dense
    return out


def encode_image(stamp: float, img: np.ndarray, encoding: str = "bgr8", frame_id=b"cam"):
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    step = img.size // h
    enc = encoding.encode()
    out = struct.pack("<IIII", 0, sec, nsec, len(frame_id)) + frame_id
    out += struct.pack("<II", h, w)
    out += struct.pack("<I", len(enc)) + enc
    out += b"\x00"
    out += struct.pack("<I", step)
    blob = img.tobytes()
    out += struct.pack("<I", len(blob)) + blob
    return out


def decode_image(data: bytes):
    """sensor_msgs/Image -> (stamp, (H, W) or (H, W, C) uint8 array, encoding)."""
    stamp, base = _read_header_stamp(data)
    height, width = struct.unpack_from("<II", data, base)
    base += 8
    (elen,) = struct.unpack_from("<I", data, base)
    base += 4
    encoding = data[base : base + elen].decode()
    base += elen
    base += 1  # is_bigendian
    (step,) = struct.unpack_from("<I", data, base)
    base += 4
    (blen,) = struct.unpack_from("<I", data, base)
    base += 4
    img = np.frombuffer(data, np.uint8, blen, base).reshape(height, step)
    ch = step // width
    if ch > 1:
        img = img.reshape(height, width, ch)
    return stamp, img, encoding


# -- high-level extraction (bag_utils equivalents) -----------------------------


def extract_imu(bag_path, imu_topic: str = "/vectornav/imu"):
    """Bag -> (timestamps, accel (N,3), gyro (N,3)) via the batch kernel."""
    from mlis_tpu_torch.runtime.native import parse_imu_batch

    reader = BagReader(bag_path)
    blobs, offsets, lengths = [], [], []
    pos = 0
    for msg in reader.read_messages([imu_topic]):
        blobs.append(msg.data)
        offsets.append(pos)
        lengths.append(len(msg.data))
        pos += len(msg.data)
    if not blobs:
        return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3))
    return parse_imu_batch(
        b"".join(blobs), np.asarray(offsets), np.asarray(lengths)
    )


def extract_odometry_tum(bag_path, topics: Sequence[str]):
    """Bag odometry -> (N, 8) TUM rows; tries topics in priority order
    (the reference's fallback list pattern,
    extract_lego_loam_trajectory.py:43-71). Header stamps win over bag time."""
    from mlis_tpu_torch.runtime.native import parse_odometry_batch

    reader = BagReader(bag_path)
    for topic in topics:
        blobs, offsets, lengths = [], [], []
        pos = 0
        for msg in reader.read_messages([topic]):
            blobs.append(msg.data)
            offsets.append(pos)
            lengths.append(len(msg.data))
            pos += len(msg.data)
        if blobs:
            return parse_odometry_batch(
                b"".join(blobs), np.asarray(offsets), np.asarray(lengths)
            )
    return np.zeros((0, 8))


def extract_stereo_pairs(
    bag_path,
    left_topic: str = "/camera_array/cam1/image_raw",
    right_topic: str = "/camera_array/cam3/image_raw",
    max_dt: float = 0.01,
):
    """Bag -> iterator of time-synced (stamp, left_img, right_img).

    The +-0.01 s pairing buffer mirrors the reference's stereo sync
    (bag_utils.py:222-372). Images decode as uint8 arrays.
    """
    reader = BagReader(bag_path)
    left_buf: List[Tuple[float, np.ndarray]] = []
    right_buf: List[Tuple[float, np.ndarray]] = []

    def try_match():
        while left_buf and right_buf:
            lt, li = left_buf[0]
            rt, ri = right_buf[0]
            if abs(lt - rt) <= max_dt:
                left_buf.pop(0)
                right_buf.pop(0)
                yield (0.5 * (lt + rt), li, ri)
            elif lt < rt:
                left_buf.pop(0)
            else:
                right_buf.pop(0)

    for msg in reader.read_messages([left_topic, right_topic]):
        stamp, img, _ = decode_image(msg.data)
        if msg.topic == left_topic:
            left_buf.append((stamp, img))
        else:
            right_buf.append((stamp, img))
        yield from try_match()


def export_euroc(
    bag_path,
    output_dir,
    left_topic: str = "/camera_array/cam1/image_raw",
    right_topic: str = "/camera_array/cam3/image_raw",
    imu_topic: str = "/vectornav/imu",
    max_dt: float = 0.01,
) -> dict:
    """Bag -> EuRoC ASL `mav0/` layout (capability parity with the
    reference's scripts/basalt/extract_to_euroc.py:33-120): cam0/cam1 PNG
    frames named by nanosecond stamp + data.csv indexes, imu0/data.csv.

    Returns counts per stream.
    """
    from pathlib import Path as _P

    out = _P(output_dir) / "mav0"
    cam0 = out / "cam0" / "data"
    cam1 = out / "cam1" / "data"
    imu0 = out / "imu0"
    for d in (cam0, cam1, imu0):
        d.mkdir(parents=True, exist_ok=True)

    try:
        from PIL import Image
    except ImportError as e:  # pillow ships with matplotlib in this env
        raise RuntimeError("PNG export requires pillow") from e

    n_pairs = 0
    rows0, rows1 = [], []
    for stamp, left, right in extract_stereo_pairs(
        bag_path, left_topic, right_topic, max_dt
    ):
        ns = int(round(stamp * 1e9))
        Image.fromarray(left).save(cam0 / f"{ns}.png")
        Image.fromarray(right).save(cam1 / f"{ns}.png")
        rows0.append(f"{ns},{ns}.png")
        rows1.append(f"{ns},{ns}.png")
        n_pairs += 1
    header = "#timestamp [ns],filename\n"
    (out / "cam0" / "data.csv").write_text(header + "\n".join(rows0) + "\n")
    (out / "cam1" / "data.csv").write_text(header + "\n".join(rows1) + "\n")

    t, accel, gyro = extract_imu(bag_path, imu_topic)
    imu_rows = [
        f"{int(round(ti * 1e9))},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}"
        for ti, a, g in zip(t, accel, gyro)
    ]
    (imu0 / "data.csv").write_text(
        "#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n" + "\n".join(imu_rows) + "\n"
    )
    return {"stereo_pairs": n_pairs, "imu_samples": len(t)}


def extract_pointclouds(bag_path, topic: str = "/ouster/points", ring_field: str = "ring"):
    """Bag -> iterator of (stamp, xyz (N,3) float32, ring (N,) int32|None)."""
    from mlis_tpu_torch.runtime.native import decode_pointcloud

    reader = BagReader(bag_path)
    for msg in reader.read_messages([topic]):
        stamp, fields, point_step, blob = decode_pointcloud2(msg.data)
        by_name = {f.name: f for f in fields}
        ring = by_name.get(ring_field)
        xyz, rings = decode_pointcloud(
            blob,
            point_step,
            x_off=by_name["x"].offset,
            y_off=by_name["y"].offset,
            z_off=by_name["z"].offset,
            ring_off=ring.offset if ring else -1,
            ring_size=1 if (ring and ring.datatype in (2,)) else 2,
        )
        yield stamp, xyz, rings
