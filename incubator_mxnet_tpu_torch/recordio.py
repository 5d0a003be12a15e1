"""RecordIO: the dmlc record file format and its indexed variant (port of
``incubator_mxnet_tpu/recordio.py``: ``MXRecordIO``, ``MXIndexedRecordIO``,
``IRHeader``, ``pack``/``unpack``/``pack_img``/``unpack_img``).

The port keeps its own copy of the format, byte for byte the JAX
package's and dmlc-core's, so a ``.rec``/``.idx`` pair written by either
package (or by the reference's ``tools/im2rec.py``) reads in the other:

  [kMagic:4][lrec:4][data:len][pad to 4B]   per record
  lrec = (cflag << 29) | length;  cflag 0=whole 1=begin 2=middle 3=end
  records whose payload contains kMagic are split at those points.

Records are read and written in Python; the JAX package's native reader
(``src/native/recordio.cc``) is not ported (ROADMAP A7).  A file cut
mid-write reads up to the tear with a warning; a corrupt frame raises an
``IOError`` carrying ``.path`` and ``.offset``.
"""
from __future__ import annotations

import io as _io
import numbers
import os
import struct
import warnings
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "unpack_img", "pack_img"]

_kMagic = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", _kMagic)


def _corrupt_record_error(uri, offset, why):
    """A locatable IOError for an unreadable record: ``path`` and
    ``offset`` ride the exception as attributes."""
    err = IOError("%s at offset %d in %s" % (why, offset, uri))
    err.path = uri
    err.offset = int(offset)
    return err


def _torn_final_record(uri, offset, why):
    """A file cut mid-write by a crash is readable up to the tear: warn
    and report end-of-file instead of raising on the final record."""
    warnings.warn(
        "torn final record in %s at offset %d (%s) — file truncated "
        "mid-write? Records up to the tear were read; stopping here."
        % (uri, offset, why), stacklevel=3)


class MXRecordIO:
    """Sequential record reader/writer (``flag`` ``"r"`` or ``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fh = None
        self.is_open = False
        self.writable = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.fh = open(self.uri, "wb" if self.writable else "rb")
        self.is_open = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        """Pickle without the file handle and reopen on unpickling
        (worker processes).  This object's handle stays open: a dataset
        is pickled once for each spawned worker."""
        d = dict(self.__dict__)
        d["fh"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        is_open = d.get("is_open", False)
        self.is_open = False
        self.fh = None
        if is_open:
            self.open()

    def close(self):
        if not self.is_open:
            return
        if self.fh is not None:
            self.fh.close()
            self.fh = None
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.fh.tell()

    def seek(self, pos):
        """Reader byte-seek."""
        if self.writable:
            raise ValueError("seek on a record file opened for writing")
        self.fh.seek(int(pos))

    def write(self, buf):
        if not self.writable:
            raise ValueError("write to a record file opened for reading")
        if not isinstance(buf, (bytes, bytearray)):
            buf = bytes(buf)
        # split the payload at embedded magics, dmlc style
        parts = []
        start = 0
        i = buf.find(_MAGIC_BYTES)
        while i != -1:
            parts.append(buf[start:i])
            start = i + 4
            i = buf.find(_MAGIC_BYTES, start)
        parts.append(buf[start:])
        for k, part in enumerate(parts):
            if len(parts) == 1:
                cflag = 0
            elif k == 0:
                cflag = 1
            elif k == len(parts) - 1:
                cflag = 3
            else:
                cflag = 2
            self.fh.write(_MAGIC_BYTES)
            self.fh.write(struct.pack("<I", (cflag << 29) | len(part)))
            self.fh.write(part)
            pad = (4 - (len(part) & 3)) & 3
            if pad:
                self.fh.write(b"\x00" * pad)

    def read(self):
        """The next record's payload, or None at the end of the file."""
        if self.writable:
            raise ValueError("read from a record file opened for writing")
        return self._read_frames(self.fh)

    def _resync(self, fh, bad_offset):
        """Leave ``fh`` at the next 4-byte-aligned magic word after a
        corrupt frame (EOF when none): one corrupt record costs the
        caller one error.  A false positive fails the next header check
        and resyncs again, so progress is monotonic."""
        pos = (int(bad_offset) + 4 + 3) & ~3
        while True:
            fh.seek(pos)
            buf = fh.read(1 << 16)
            if not buf:
                fh.seek(0, 2)
                return
            i = 0
            while True:
                i = buf.find(_MAGIC_BYTES, i)
                if i == -1:
                    break
                if (pos + i) % 4 == 0:
                    fh.seek(pos + i)
                    return
                i += 1
            # keep a 3-byte overlap: an aligned magic can straddle the
            # chunk boundary only when the chunk ends off-alignment (EOF)
            pos += max(len(buf) - 3, 1)

    def _read_frames(self, fh):
        """Validate magic and length frame by frame; a torn final record
        warns and ends the file, corruption raises a locatable
        ``IOError`` with ``fh`` left at the next frame boundary."""
        out = bytearray()
        expect_more = False
        while True:
            offset = fh.tell()
            head = fh.read(8)
            if len(head) == 0 and not expect_more:
                return None
            if len(head) < 8:
                _torn_final_record(
                    self.uri, offset,
                    "partial continuation frame" if expect_more
                    else "only %d of 8 header bytes" % len(head))
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _kMagic:
                self._resync(fh, offset)
                raise _corrupt_record_error(
                    self.uri, offset,
                    "invalid record magic 0x%08X (expected 0x%08X)"
                    % (magic, _kMagic))
            cflag = lrec >> 29
            length = lrec & ((1 << 29) - 1)
            if cflag in (2, 3) and not expect_more:
                # a continuation whose begin frame was the corrupt one
                # resynced past: skip it, report it
                fh.seek(length + ((4 - (length & 3)) & 3), 1)
                raise _corrupt_record_error(
                    self.uri, offset,
                    "continuation frame (cflag %d) without a begin frame"
                    % cflag)
            data = fh.read(length)
            if len(data) < length:
                # a torn final record, or a corrupt length mid-file that
                # over-reads into intact frames: a later aligned magic
                # tells them apart
                self._resync(fh, offset + 4)
                next_frame = fh.tell()
                fh.seek(0, 2)
                if next_frame < fh.tell():
                    fh.seek(next_frame)
                    raise _corrupt_record_error(
                        self.uri, offset,
                        "record length %d over-reads into a later frame "
                        "(only %d payload bytes before the next frame "
                        "boundary) — corrupt length field?"
                        % (length, len(data)))
                _torn_final_record(
                    self.uri, offset,
                    "header promises %d payload bytes, only %d on disk"
                    % (length, len(data)))
                return None
            pad = (4 - (length & 3)) & 3
            if pad:
                fh.read(pad)
            if cflag == 0:
                return bytes(data)
            if cflag == 1:
                out = bytearray(data)
                expect_more = True
            else:
                out += _MAGIC_BYTES
                out += data
                if cflag == 3:
                    return bytes(out)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file through an ``.idx`` sidecar
    (``key\\toffset`` lines)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        if self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def __getstate__(self):
        d = super().__getstate__()
        d["fidx"] = None
        return d

    def seek(self, idx):
        super().seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# IRHeader: flag, label, id, id2 — struct 'IfQQ'
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader and raw bytes into one record payload; a vector
    label rides after the header as float32 with ``flag`` its length."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        ret = struct.pack(_IR_FORMAT, header.flag, float(header.label),
                          header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        ret = struct.pack(_IR_FORMAT, header.flag, header.label,
                          header.id, header.id2)
        ret += label.tobytes()
    return ret + s


def unpack(s):
    """Unpack a record payload into ``(IRHeader, bytes)``."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[: header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=1):
    """Unpack a record into ``(header, HWC uint8 image)``."""
    header, s = unpack(s)
    return header, _imdecode(s, iscolor)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack a header and an encoded image (``.jpg``, ``.png``, ``.npy``)."""
    return pack(header, _imencode(img, quality=quality, img_fmt=img_fmt))


def _imdecode(buf, iscolor=1):
    """Decode an image payload: raw ``.npy`` always, JPEG/PNG through
    cv2 or PIL where one is installed."""
    if isinstance(buf, (bytes, bytearray)) and bytes(buf[:6]) == b"\x93NUMPY":
        return np.load(_io.BytesIO(bytes(buf)))
    try:
        import cv2
        arr = np.frombuffer(buf, dtype=np.uint8)
        img = cv2.imdecode(arr, 1 if iscolor else 0)
        return img[..., ::-1] if iscolor else img  # BGR -> RGB
    except ImportError:
        pass
    try:
        from PIL import Image
        img = Image.open(_io.BytesIO(bytes(buf)))
        return np.asarray(img.convert("RGB" if iscolor else "L"))
    except ImportError as e:
        raise ImportError(
            "decoding compressed images requires cv2 or PIL; "
            "raw .npy payloads are always supported") from e


def _imencode(img, quality=95, img_fmt=".jpg"):
    img = np.asarray(img)
    if img_fmt != ".npy":
        try:
            from PIL import Image
        except ImportError:
            Image = None  # without PIL the payload is raw .npy
        if Image is not None:
            bio = _io.BytesIO()
            fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}[
                img_fmt.lstrip(".").lower()]
            Image.fromarray(img).save(bio, format=fmt, quality=quality)
            return bio.getvalue()
    bio = _io.BytesIO()
    np.save(bio, img)
    return bio.getvalue()
