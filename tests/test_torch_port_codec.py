"""The port's host image codec (csrc/image_codec.c through
centertrack_tpu_torch.utils.jpeg and utils.image_io) against OpenCV on
the CPU, and its build.

Tolerances: none. ``image_io.read`` equals ``cv2.imread`` bit for bit on
every JPEG and PNG here (files written by cv2 at several qualities,
samplings, restart intervals and sizes, by PIL with optimised Huffman
tables, and PNGs of every Average or Paeth row); ``image_io.write`` to a
``.jpg`` writes the bytes of ``cv2.imwrite``. What the codec does not
decode raises ``NotImplementedError`` naming ROADMAP A6d; truncated or
corrupt data raises ``ValueError``.
"""

import io
import os
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

import bench
import chip_smoke
from centertrack_tpu_torch.ops import _build
from centertrack_tpu_torch.utils import image_io, jpeg
from tests.test_torch_port_data import _png_with_filter

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _image(shape, seed):
    """Smooth colour with noisy rows: both flat and busy blocks."""
    rng = np.random.RandomState(seed)
    h, w = shape[:2]
    small = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2) + shape[2:])
    img = cv2.resize(small.astype(np.uint8), (w, h),
                     interpolation=cv2.INTER_CUBIC).reshape(shape)
    img[::5] = rng.randint(0, 256, img[::5].shape)
    return img


def _cv2_file(tmp_path, img, name="a.jpg", **params):
    flags = []
    for key, value in params.items():
        flags += [getattr(cv2, "IMWRITE_JPEG_" + key.upper()), value]
    path = str(tmp_path / name)
    assert cv2.imwrite(path, img, flags)
    return path


def _same_as_cv2(path):
    got = image_io.read(path)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, cv2.imread(path))


# ---- decoding ---------------------------------------------------------------
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("shape", [(61, 83, 3), (61, 83)])
def test_decode_qualities(quality, shape, tmp_path):
    _same_as_cv2(_cv2_file(tmp_path, _image(shape, quality), quality=quality))


@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_samplings_and_restart_intervals(sampling, restart, tmp_path):
    img = _image((45, 71, 3), restart)
    _same_as_cv2(_cv2_file(tmp_path, img, quality=90,
                           sampling_factor=SAMPLING[sampling],
                           rst_interval=restart))


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 1), (2, 3, 3), (17, 33, 3),
                                   (33, 17), (1081, 1921, 3)])
def test_decode_odd_sizes(shape, tmp_path):
    _same_as_cv2(_cv2_file(tmp_path, _image(shape, shape[0])))


def test_decode_a_1080p_bench_frame(tmp_path):
    frame = bench.synth_frames(1, seed=4)[0]
    _same_as_cv2(_cv2_file(tmp_path, frame))


@pytest.mark.parametrize("kw", [dict(optimize=True),
                                dict(optimize=True, subsampling=0),
                                dict(optimize=True, subsampling=1,
                                     quality=30)],
                         ids=["420", "444", "422_q30"])
@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 50, 3), (37, 50)])
def test_decode_pil_optimized_huffman_tables(kw, shape, tmp_path):
    img = _image(shape, 9)
    pil = Image.fromarray(img[..., ::-1] if img.ndim == 3 else img)
    path = str(tmp_path / "pil.jpg")
    pil.save(path, "JPEG", **kw)
    _same_as_cv2(path)


def test_decode_in_threads_at_once():
    """ctypes releases the GIL: eight threads decode together, each
    getting its own image."""
    frames = [_image((120, 160, 3), s) for s in range(8)]
    files = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]
    got = [None] * 8

    def work(i):
        for _ in range(3):
            got[i] = jpeg.decode(files[i])
    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for f, g in zip(files, got):
        np.testing.assert_array_equal(
            g, cv2.imdecode(np.frombuffer(f, np.uint8), cv2.IMREAD_COLOR))


def test_read_routes_by_content(tmp_path):
    """A JPEG named .png and a PNG named .jpg read by what they hold."""
    img = _image((20, 30, 3), 1)
    jpg_as_png = _cv2_file(tmp_path, img, "jpeg_inside.png.tmp.jpg")
    os.rename(jpg_as_png, str(tmp_path / "jpeg_inside.png"))
    png_path = str(tmp_path / "png_inside.png")
    cv2.imwrite(png_path, img)
    os.rename(png_path, str(tmp_path / "png_inside.jpg"))
    for name in ("jpeg_inside.png", "png_inside.jpg"):
        np.testing.assert_array_equal(
            image_io.read(str(tmp_path / name)),
            cv2.imdecode(np.fromfile(str(tmp_path / name), np.uint8),
                         cv2.IMREAD_COLOR))


# ---- encoding ---------------------------------------------------------------
@pytest.mark.parametrize("quality", [None, 75, 90])
@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 33, 3), (97, 131, 3),
                                   (1, 1), (17, 33), (97, 131)])
def test_encode_equals_cv2(shape, quality, tmp_path):
    img = _image(shape, 3)
    flags = [] if quality is None else [cv2.IMWRITE_JPEG_QUALITY, quality]
    want = cv2.imencode(".jpg", img, flags)[1].tobytes()
    path = str(tmp_path / "ours.jpeg")
    if quality is None:
        image_io.write(path, img)
    else:
        image_io.write(path, img, quality)
    with open(path, "rb") as f:
        assert f.read() == want
    assert jpeg.encode(img, 95 if quality is None else quality) == want


def test_encode_a_1080p_bench_frame_equals_cv2():
    frame = bench.synth_frames(1, seed=6)[0]
    assert jpeg.encode(frame) == cv2.imencode(".jpg", frame)[1].tobytes()


def test_encode_refuses_other_arrays():
    for bad in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.float32),
                np.zeros((4,), np.uint8)):
        with pytest.raises(ValueError):
            jpeg.encode(bad)
    with pytest.raises(NotImplementedError, match="JPEG and PNG"):
        image_io.write("a.bmp", np.zeros((4, 4, 3), np.uint8))


# ---- PNG -------------------------------------------------------------------
@pytest.mark.parametrize("kind", [3, 4])
@pytest.mark.parametrize("shape", [(1, 1, 3), (19, 23, 3), (64, 97, 3)])
def test_png_average_and_paeth_rows_in_c(kind, shape, tmp_path):
    img = _image(shape, kind)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filter(img, kind))
    np.testing.assert_array_equal(cv2.imread(path), img)
    np.testing.assert_array_equal(image_io.read(path), img)


def test_png_rows_of_mixed_filters_and_a_bad_type():
    """chip_smoke's numpy filter (rows alternating Average and Paeth)
    decodes to its source; a filter type past 4 raises ValueError."""
    img = _image((40, 57, 3), 2)
    data = chip_smoke.png_filtered(img, (3, 4))
    np.testing.assert_array_equal(image_io.decode_png(data), img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR), img)
    raw = np.zeros((2, 7), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        jpeg.png_unfilter(raw.reshape(-1), 2, 6, 3)


# ---- what the codec refuses ------------------------------------------------
def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _patched(data, marker, at, value):
    """``data`` with the byte ``at`` past the first ``marker`` set."""
    out = bytearray(data)
    out[data.index(marker) + at] = value
    return bytes(out)


def _refusals():
    rgb = Image.fromarray(_image((24, 40, 3), 5)[..., ::-1])
    base = cv2.imencode(".jpg", _image((24, 40, 3), 5))[1].tobytes()
    exif = Image.Exif()
    exif[0x0112] = 6
    return {
        "progressive": _pil_bytes(rgb, progressive=True),
        "exif_orientation_6": _pil_bytes(rgb, exif=exif.tobytes()),
        "cmyk": _pil_bytes(rgb.convert("CMYK")),
        "arithmetic": _patched(base, b"\xff\xc0", 1, 0xC9),
        "12_bit": _patched(base, b"\xff\xc0", 4, 12),
        "lossless": _patched(base, b"\xff\xc0", 1, 0xC3),
        "sampling_4x1": cv2.imencode(".jpg", _image((24, 40, 3), 5), [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes(),
    }


@pytest.mark.parametrize("kind", list(_refusals()))
def test_unsupported_jpegs_raise_naming_a6d(kind, tmp_path):
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(_refusals()[kind])
    with pytest.raises(NotImplementedError, match="A6d"):
        image_io.read(path)


def test_exif_orientation_1_decodes_as_cv2(tmp_path):
    exif = Image.Exif()
    exif[0x0112] = 1
    path = str(tmp_path / "o1.jpg")
    with open(path, "wb") as f:
        f.write(_pil_bytes(Image.fromarray(_image((24, 40, 3), 8)),
                           exif=exif.tobytes()))
    _same_as_cv2(path)


@pytest.mark.parametrize("cut", [0.5, 0.9, 30, 200])
def test_truncated_jpegs_raise_value_error(cut):
    data = cv2.imencode(".jpg", _image((64, 80, 3), 1))[1].tobytes()
    n = int(len(data) * cut) if cut < 1 else cut
    with pytest.raises(ValueError):
        jpeg.decode(data[:n])


def test_corrupt_jpegs_raise_value_error():
    data = bytearray(cv2.imencode(".jpg", _image((64, 80, 3), 2))[1])
    sos = bytes(data).index(b"\xff\xda")
    bad_table = bytes(data[:sos + 5]) + b"\x07" + bytes(data[sos + 6:])
    for bad in (b"\xff\xd8\xff\xd9", b"\xff\xd8garbage", bad_table,
                bytes(data[:2]) + b"\xff\x00" + bytes(data[2:])):
        with pytest.raises(ValueError):
            jpeg.decode(bad)
    with pytest.raises(NotImplementedError, match="JPEG and PNG"):
        image_io.decode_png(b"GIF89a")


@pytest.mark.parametrize("seed", range(4))
def test_mutated_jpegs_decode_or_raise(seed):
    """Random byte flips, cuts, insertions, deletions and stray markers
    in valid files of each kind (4:2:0, gray, 4:4:4 and 4:2:2 with
    restarts, PIL's optimised tables): each decodes to a BGR image or
    raises ValueError or NotImplementedError, and the process lives."""
    rng = np.random.RandomState(seed)
    pil = io.BytesIO()
    Image.fromarray(_image((31, 45, 3), seed)).save(pil, "JPEG",
                                                     optimize=True)
    bases = [cv2.imencode(".jpg", _image((37, 53, 3), seed))[1],
             cv2.imencode(".jpg", _image((40, 33), seed))[1],
             cv2.imencode(".jpg", _image((29, 61, 3), seed), [
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 1])[1],
             cv2.imencode(".jpg", _image((17, 17, 3), seed), [
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1],
             np.frombuffer(pil.getvalue(), np.uint8)]
    outcomes = set()
    for _ in range(100):
        data = bytearray(bases[rng.randint(len(bases))].tobytes())
        for _ in range(rng.randint(1, 7)):
            at = rng.randint(len(data) + 1)
            kind = rng.randint(5)
            if kind == 0 and at < len(data):
                data[at] = rng.randint(256)
            elif kind == 1:
                del data[at:]
            elif kind == 2:
                data[at:at] = rng.randint(0, 256, rng.randint(1, 9)).tobytes()
            elif kind == 3:
                del data[at:at + rng.randint(1, 9)]
            else:
                data[at:at] = bytes([0xFF, rng.choice(
                    [0xC4, 0xDB, 0xDD, 0xDA, 0xC0, 0xD9, 0xD0, 0xE1])])
        try:
            out = jpeg.decode(bytes(data))
            assert out.dtype == np.uint8 and out.ndim == 3
            outcomes.add("decoded")
        except (ValueError, NotImplementedError) as e:
            outcomes.add(type(e).__name__)
    assert {"decoded", "ValueError"} <= outcomes


# ---- the chip smoke's codec goldens ----------------------------------------
@pytest.mark.parametrize("case", chip_smoke.CODEC_CASES,
                         ids=[f"{n}@{q}" for n, q in chip_smoke.CODEC_CASES])
def test_smoke_codec_goldens_are_cv2s(case):
    """chip_smoke's CODEC_GOLDEN, recomputed with cv2 (the file's bytes
    and the decoded pixels), and the port giving the same here."""
    name, quality = case
    img = chip_smoke.codec_inputs()[name]
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                      quality])[1].tobytes()
    pixels = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    want = (chip_smoke.sha256(data),
            chip_smoke.sha256(np.ascontiguousarray(pixels)))
    assert chip_smoke.CODEC_GOLDEN[f"{name}@{quality}"] == want
    ours = jpeg.encode(img, quality)
    assert (chip_smoke.sha256(ours),
            chip_smoke.sha256(jpeg.decode(ours))) == want


# ---- the build -------------------------------------------------------------
def test_host_build_is_keyed_and_atomic(tmp_path, monkeypatch):
    """cc -O2 -shared -fPIC into build/torch_kernels/image_codec-host-<hash>
    through a temporary file; a second build finds the library."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "build_info", {})
    path = _build.build_host("image_codec")
    assert path == _build.host_library_path("image_codec")
    assert os.path.basename(path).startswith("image_codec-host-")
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    assert _build.build_info["image_codec"]["seconds"] > 0
    assert _build.build_host("image_codec") == path


def test_host_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_cc", lambda: "/fake/cc")

    def fake_run(cmd, capture_output, text, timeout):
        assert cmd[:4] == ["/fake/cc", "-O2", "-shared", "-fPIC"]
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"partial")

        class Failed:
            returncode, stdout, stderr = 1, "", "image_codec.c: error"
        return Failed()
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="cc failed on image_codec"):
        _build.build_host("image_codec")
    assert os.listdir(tmp_path) == []


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CC", raising=False)
    with pytest.raises(RuntimeError, match="no host C compiler"):
        _build.find_cc()
