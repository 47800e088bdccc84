"""The port's libav shim (``ingest/av.py`` over its own ``native/vepav.cpp``)
against the JAX package's on the same encoded clip.

One H.264 clip (``write_test_video``, 320x240, 60 frames, a keyframe every
10) is made once for the module by the JAX package. Both packages demux it
to equal packets (payload bytes, pts, dts, duration, key flags), decode it
to bit-equal BGR24 frames (tolerance 0: the same libavcodec decodes the
same bytes), stream-copy it into MP4 and FLV files that demux back to the
same packets, and write fixtures of their own that decode to the same
frames. The port builds its shim from its own source into ``build/native/``.
"""

import os

import numpy as np
import pytest

from video_edge_ai_proxy_tpu.ingest import av as jav
from video_edge_ai_proxy_tpu_torch.ingest import av
from video_edge_ai_proxy_tpu_torch.utils import cbuild


@pytest.fixture(scope="module", autouse=True)
def _libav():
    """Both shims build here (at their first use, not at import)."""
    if not (av.available() and jav.available()):
        pytest.skip("the FFmpeg development files are not on this host")


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N, FPS, GOP = 320, 240, 60, 30.0, 10
PACKAGES = {"port": av, "jax": jav}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_av") / "clip.mp4")
    jav.write_test_video(path, W, H, frames=N, fps=FPS, gop=GOP)
    return path


@pytest.fixture(scope="module")
def audio_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_av_audio") / "clip_audio.mp4")
    jav.write_test_video(path, W, H, frames=N, fps=FPS, gop=GOP, audio=True)
    return path


def packet_tuples(pkts):
    return [(p.pts, p.dts, p.duration, p.is_keyframe, p.is_corrupt, p.is_audio, p.data)
            for p in pkts]


def demux(mod, path, want_data=True):
    with mod.PacketDemuxer(path) as d:
        pkts = []
        while (pkt := d.read(want_data=want_data)) is not None:
            pkts.append(pkt)
        return d.info, d.audio_info, pkts


def decode_all(mod, path):
    """Every frame of ``path`` in decode order, with its pts and picture type."""
    out = []
    with mod.PacketDemuxer(path) as d:
        while (pkt := d.read()) is not None:
            if pkt.is_audio:
                continue
            frame = d.decode()
            if frame is not None:
                out.append((frame, d.last_frame_pts, d.last_frame_type))
        while (frame := d.drain()) is not None:
            out.append((frame, d.last_frame_pts, d.last_frame_type))
    return out


def info_tuple(info):
    return None if info is None else (info.width, info.height, info.codec_id, info.codec_name,
                                      info.time_base, info.fps, info.extradata,
                                      info.sample_rate, info.channels)


def test_the_shim_builds_from_the_ports_own_source_into_build_native():
    lib = av._load()
    assert av._SRC == os.path.join(ROOT, "video_edge_ai_proxy_tpu_torch", "ingest", "native",
                                   "vepav.cpp")
    assert av._SRC != jav._SRC
    assert av._LDFLAGS == jav._LDFLAGS == ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
    assert cbuild.BUILD_DIR == __import__("pathlib").Path(ROOT) / "build" / "native"
    built = cbuild.build_library(av._SRC, "vepav", av._LDFLAGS)
    assert os.path.dirname(built) == os.path.join(ROOT, "build", "native")
    assert lib._name == built
    assert os.path.basename(built).startswith("libvepav-")


@pytest.mark.parametrize("want_data", [True, False], ids=["with_payload", "demux_only"])
def test_both_packages_demux_the_same_packets(clip, want_data):
    port, jax_ = demux(av, clip, want_data), demux(jav, clip, want_data)
    assert info_tuple(port[0]) == info_tuple(jax_[0])
    assert port[1] is None and jax_[1] is None
    assert packet_tuples(port[2]) == packet_tuples(jax_[2])
    pkts = port[2]
    assert len(pkts) == N
    assert [i for i, p in enumerate(pkts) if p.is_keyframe] == list(range(0, N, GOP))
    if want_data:
        assert all(p.data for p in pkts)
    else:
        assert not any(p.data for p in pkts)


def test_both_packages_demux_the_same_audio_track(audio_clip):
    port, jax_ = demux(av, audio_clip), demux(jav, audio_clip)
    assert info_tuple(port[0]) == info_tuple(jax_[0])
    assert info_tuple(port[1]) == info_tuple(jax_[1])
    assert port[1].codec_name == "aac" and port[1].channels == 1
    assert packet_tuples(port[2]) == packet_tuples(jax_[2])
    assert sum(p.is_audio for p in port[2]) > 0
    assert sum(not p.is_audio for p in port[2]) == N


def test_both_packages_decode_bit_equal_frames(clip):
    port, jax_ = decode_all(av, clip), decode_all(jav, clip)
    assert len(port) == len(jax_) == N
    for (pf, ppts, ptype), (jf, jpts, jtype) in zip(port, jax_):
        assert pf.shape == (H, W, 3) and pf.dtype == np.uint8
        np.testing.assert_array_equal(pf, jf)
        assert (ppts, ptype) == (jpts, jtype)
    assert [t for _, _, t in port][::GOP] == ["I"] * (N // GOP)


def test_decoding_with_a_too_small_buffer_keeps_every_frame(clip):
    """The shim's ENOSPC path (a camera switched to a larger mode): the
    resized retry converts the frame it holds, in both packages."""
    counts = {}
    for name, mod in PACKAGES.items():
        with mod.PacketDemuxer(clip) as d:
            d._frame_buf = np.empty(16, np.uint8)
            frames = []
            while d.read() is not None:
                f = d.decode()
                if f is not None:
                    frames.append(f)
            while (f := d.drain()) is not None:
                frames.append(f)
        counts[name] = frames
    assert len(counts["port"]) == len(counts["jax"]) == N
    for a, b in zip(counts["port"], counts["jax"]):
        np.testing.assert_array_equal(a, b)


def test_a_mid_gop_join_waits_for_the_next_keyframe_in_both(clip):
    got = {}
    for name, mod in PACKAGES.items():
        with mod.PacketDemuxer(clip) as d:
            decoded_at = []
            for i in range(25):
                d.read()
                if i >= 15 and d.decode() is not None:
                    decoded_at.append(i)
        got[name] = decoded_at
    assert got["port"] == got["jax"] and got["port"][0] >= 20


@pytest.mark.parametrize("fmt,ext", [("", "mp4"), ("flv", "flv")])
def test_stream_copy_remux_demuxes_to_the_same_packets(clip, tmp_path, fmt, ext):
    """One GOP (packets 10-19) rebased to 0 through each package's muxer:
    the two files demux to the same packets, the payloads the source's."""
    info, _, pkts = demux(jav, clip)
    gop = pkts[GOP:2 * GOP]
    out = {}
    for name, mod in PACKAGES.items():
        path = str(tmp_path / f"{name}.{ext}")
        minfo = mod.StreamInfo(**{k: getattr(info, k) for k in vars(info)})
        mux = mod.StreamCopyMuxer(path, minfo, format=fmt)
        with mux:
            for p in gop:
                mux.write(mod.Packet(**vars(p)), ts_offset=gop[0].dts)
        assert mux.packets == GOP
        out[name] = demux(jav, path)
    assert info_tuple(out["port"][0]) == info_tuple(out["jax"][0])
    assert packet_tuples(out["port"][2]) == packet_tuples(out["jax"][2])
    assert [p.data for p in out["port"][2]] == [p.data for p in gop]
    assert out["port"][2][0].is_keyframe


def test_write_test_video_decodes_to_the_frames_jaxs_does(tmp_path):
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.mp4")
        info = mod.write_test_video(paths[name], W, H, frames=N // 2, fps=FPS, gop=GOP)
        assert info.codec_name == "h264" and info.extradata
    port, jax_ = decode_all(av, paths["port"]), decode_all(jav, paths["jax"])
    assert len(port) == len(jax_) == N // 2
    for (pf, ppts, ptype), (jf, jpts, jtype) in zip(port, jax_):
        np.testing.assert_array_equal(pf, jf)
        assert (ppts, ptype) == (jpts, jtype)
    assert packet_tuples(demux(av, paths["port"])[2]) == \
        packet_tuples(demux(av, paths["jax"])[2])


def test_encoders_report_and_refuse_alike():
    assert av.encoder_available("libx264") == jav.encoder_available("libx264")
    assert av.encoder_available("no_such_codec") is jav.encoder_available("no_such_codec") \
        is False
    for mod in PACKAGES.values():
        with pytest.raises(IOError):
            enc = mod.Encoder(321, 240)
            enc.encode(np.zeros((240, 321, 3), np.uint8))
    with av.Encoder(W, H, gop=GOP) as enc, jav.Encoder(W, H, gop=GOP) as jenc:
        assert info_tuple(enc.info) == info_tuple(jenc.info)
        frame = np.random.default_rng(0).integers(0, 256, (H, W, 3), dtype=np.uint8)
        pkts = [p for i in range(3) for p in enc.encode(frame, pts=i)] + enc.flush()
        jpkts = [p for i in range(3) for p in jenc.encode(frame, pts=i)] + jenc.flush()
        assert packet_tuples(pkts) == packet_tuples(jpkts)
