// vepav: packet-level demux / stream-copy mux / decode / encode shim over
// the system FFmpeg libraries, exposed as a plain C ABI for ctypes.
//
// The port's own copy of video_edge_ai_proxy_tpu/ingest/native/vepav.cpp,
// with the same C ABI, built at first use by utils/cbuild.py into
// build/native/ and bound in ingest/av.py.
//
// This is the native layer the reference reaches through PyAV
// (python/rtsp_to_rtmp.py:63-110 demuxes, python/read_image.py:87-94
// decodes, python/archive.py:75-100 muxes compressed GOPs,
// rtsp_to_rtmp.py:163-182 remuxes to RTMP). The same four capabilities are
// bound directly against libavformat, libavcodec, libavutil and libswscale:
//
//   va_*  demux:  real packet boundaries, is_keyframe, pts/dts/time_base,
//                 demux-only reads (NO codec work — the lazy-decode gate
//                 actually saves decode CPU, unlike cv2's grab()).
//   va_decode:    H.264/HEVC/... -> BGR24 via avcodec + swscale, opened
//                 lazily on the first decode so idle demux never pays it.
//   vm_*  mux:    stream-copy remux of compressed packets into MP4 segments
//                 (archive) or FLV/RTMP (pass-through) — zero transcode.
//   vc_*  encode: BGR24 -> H.264 (libx264) for test fixtures and the
//                 re-encode fallback paths.
//
// FFmpeg API changes are guarded by version checks (AV_FRAME_FLAG_KEY from
// libavutil 58, the ch_layout channel API), so one source builds against
// FFmpeg 5 and later.
//
// Error convention: functions returning int use 0 (or a positive size) for
// success, VA_EOF for end-of-stream, negative AVERROR codes otherwise;
// va_strerror renders them.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>

#define VA_EOF 1

extern "C" {

struct VAStreamInfo {
  int32_t width;
  int32_t height;
  int32_t codec_id;   // AVCodecID
  int32_t tb_num;     // stream time_base (pts/dts units)
  int32_t tb_den;
  int32_t fps_num;    // best-effort frame rate
  int32_t fps_den;
  int32_t extradata_len;
  int32_t sample_rate;  // audio streams only (0 for video)
  int32_t channels;     // audio streams only (0 for video)
  char codec_name[32];
};

struct VAPacketMeta {
  int64_t pts;
  int64_t dts;
  int64_t duration;
  int32_t size;
  int32_t is_keyframe;
  int32_t is_corrupt;
  int32_t is_audio;   // 1 = packet belongs to the demuxed audio stream
};

struct VAFrameMeta {
  int64_t pts;        // best-effort presentation timestamp (stream tb)
  int32_t width;
  int32_t height;
  int32_t is_keyframe;
  int32_t pict_type;  // AVPictureType: 1=I 2=P 3=B ...
};

}  // extern "C" (structs)

namespace {

std::once_flag g_net_once;

void net_init() {
  std::call_once(g_net_once, [] { avformat_network_init(); });
}

void set_err(char* buf, int cap, const char* msg) {
  if (buf && cap > 0) {
    std::snprintf(buf, cap, "%s", msg);
  }
}

void set_averr(char* buf, int cap, int err) {
  if (buf && cap > 0) {
    av_strerror(err, buf, cap);
  }
}

struct Demux {
  AVFormatContext* fmt = nullptr;
  int vstream = -1;
  int astream = -1;              // best audio stream, -1 when none
  AVPacket* pkt = nullptr;       // current demuxed packet
  bool pkt_valid = false;
  bool pkt_sent = false;         // current packet already fed to decoder
  bool frame_pending = false;    // dequeued frame awaiting a big-enough buf
  AVCodecContext* dec = nullptr; // lazy
  AVFrame* frame = nullptr;
  SwsContext* sws = nullptr;
  int decode_threads = 1;        // caller opt-in ("decode_threads=N"):
                                 // frame threading for cameras whose
                                 // decode exceeds one core (e.g. 4K).
                                 // Default 1 = today's behavior; the
                                 // worker already handles the added
                                 // decoder delay (grab/retrieve split +
                                 // frame-pts passthrough).
};

struct Mux {
  AVFormatContext* fmt = nullptr;
  AVStream* st = nullptr;
  AVStream* ast = nullptr;       // optional audio stream
  AVRational in_tb{1, 90000};   // time base of pts/dts handed to vm_write
  AVRational in_atb{1, 48000};  // time base of pts/dts handed to vm_write_audio
  bool header = false;
};

struct Enc {
  AVCodecContext* ctx = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  SwsContext* sws = nullptr;
  int64_t next_pts = 0;
};

// After avformat_open_input / avformat_write_header, entries the consumer
// didn't take remain in `opts`. A CALLER-supplied key among them is a typo
// or unsupported option that would otherwise degrade silently into a
// baffling connection error; built-in defaults (e.g. the speculative
// "stimeout") are exempt because only keys parsed from `options` are
// checked. Returns true and fills err when one is found.
bool unconsumed_user_option(AVDictionary* opts, const char* options,
                            char* err, int errcap) {
  if (!options || !*options) return false;
  AVDictionary* user = nullptr;
  av_dict_parse_string(&user, options, "=", ":", 0);
  const AVDictionaryEntry* e = nullptr;
  bool found = false;
  while ((e = av_dict_get(user, "", e, AV_DICT_IGNORE_SUFFIX)) != nullptr) {
    if (av_dict_get(opts, e->key, nullptr, 0) != nullptr) {
      char msg[128];
      std::snprintf(msg, sizeof msg, "unknown option '%s'", e->key);
      set_err(err, errcap, msg);
      found = true;
      break;
    }
  }
  av_dict_free(&user);
  return found;
}

int open_decoder(Demux* d) {
  const AVCodecParameters* par = d->fmt->streams[d->vstream]->codecpar;
  const AVCodec* codec = avcodec_find_decoder(par->codec_id);
  if (!codec) return AVERROR_DECODER_NOT_FOUND;
  d->dec = avcodec_alloc_context3(codec);
  if (!d->dec) return AVERROR(ENOMEM);
  int rc = avcodec_parameters_to_context(d->dec, par);
  if (rc < 0) return rc;
  d->dec->pkt_timebase = d->fmt->streams[d->vstream]->time_base;
  if (d->decode_threads != 1) {
    // 0 = auto (one per core). Frame+slice threading: real multi-core
    // scaling for high-rate cameras at the cost of decoder delay, which
    // the worker's grab/retrieve split already accounts for.
    d->dec->thread_count = d->decode_threads;
    d->dec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
  }
  rc = avcodec_open2(d->dec, codec, nullptr);
  if (rc < 0) return rc;
  d->frame = av_frame_alloc();
  return d->frame ? 0 : AVERROR(ENOMEM);
}

// Convert d->frame to packed BGR24 into out (cap bytes). Returns byte size
// written, or AVERROR(ENOSPC) with the frame KEPT pending and fm filled
// with its real dimensions so the caller can size a buffer and retry —
// the dequeued frame must never be lost to a too-small buffer.
int frame_to_bgr(Demux* d, uint8_t* out, int64_t cap, VAFrameMeta* fm) {
  AVFrame* f = d->frame;
  const int w = f->width, h = f->height;
  if (fm) {
    fm->pts = f->best_effort_timestamp;
    fm->width = w;
    fm->height = h;
#if LIBAVUTIL_VERSION_MAJOR >= 58  // AV_FRAME_FLAG_KEY landed in ffmpeg 6
    fm->is_keyframe = (f->flags & AV_FRAME_FLAG_KEY) ? 1 : 0;
#else
    fm->is_keyframe = f->key_frame ? 1 : 0;
#endif
    fm->pict_type = (int32_t)f->pict_type;
  }
  const int64_t need = (int64_t)w * h * 3;
  if (need > cap) {
    d->frame_pending = true;
    return AVERROR(ENOSPC);
  }
  d->sws = sws_getCachedContext(d->sws, w, h, (AVPixelFormat)f->format, w, h,
                                AV_PIX_FMT_BGR24, SWS_BILINEAR, nullptr,
                                nullptr, nullptr);
  if (!d->sws) return AVERROR(EINVAL);
  uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
  int dst_stride[4] = {3 * w, 0, 0, 0};
  sws_scale(d->sws, f->data, f->linesize, 0, h, dst, dst_stride);
  d->frame_pending = false;
  return (int)need;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- demux --

// Open url for demuxing. timeout_us guards RTSP/network I/O (reference uses
// tcp transport + 5 s socket timeouts, rtsp_to_rtmp.py:63). `options` is an
// optional "k=v:k=v" AVOption string merged on top (e.g.
// "rtsp_flags=listen" accepts a pushed RTSP session — how the tests drive
// the real rtsp:// network path without a camera). Returns handle or null
// (err filled).
void* va_open(const char* url, int64_t timeout_us, const char* options,
              char* err, int errcap) {
  net_init();
  Demux* d = new Demux();
  AVDictionary* opts = nullptr;
  char buf[32];
  std::snprintf(buf, sizeof buf, "%lld", (long long)timeout_us);
  if (std::strncmp(url, "rtsp", 4) == 0) {
    av_dict_set(&opts, "rtsp_transport", "tcp", 0);
    av_dict_set(&opts, "timeout", buf, 0);   // ffmpeg5 rtsp socket timeout
    av_dict_set(&opts, "stimeout", buf, 0);  // older name; ignored if unknown
    av_dict_set(&opts, "max_delay", "5000000", 0);
  } else if (std::strstr(url, "://") != nullptr) {
    // Every other network protocol (rtmp incl. listen mode, http, tcp):
    // the generic avio I/O timeout, so a peer that never speaks cannot
    // block a caller forever.
    av_dict_set(&opts, "rw_timeout", buf, 0);
  }
  if (options && *options) {
    int prc = av_dict_parse_string(&opts, options, "=", ":", 0);
    if (prc < 0) {
      set_err(err, errcap, "malformed options string (want k=v:k=v)");
      av_dict_free(&opts);
      delete d;
      return nullptr;
    }
  }
  // "decode_threads" is OURS (decoder setup), not an AVOption: consume
  // it before avformat sees the dict, or the unconsumed-option check
  // would reject it as a typo.
  if (const AVDictionaryEntry* e =
          av_dict_get(opts, "decode_threads", nullptr, 0)) {
    // Strict value parse to match the strict key check below: "auto"
    // (atoi -> 0) or a negative count must fail HERE with a clear
    // message, not silently enable per-core threading fleet-wide or
    // surface later as a baffling decoder-init error.
    char* endp = nullptr;
    long n = std::strtol(e->value, &endp, 10);
    if (endp == e->value || *endp != '\0' || n < 0 || n > 256) {
      set_err(err, errcap,
              "decode_threads must be an integer 0..256 (0 = auto)");
      av_dict_free(&opts);
      delete d;
      return nullptr;
    }
    d->decode_threads = (int)n;
    av_dict_set(&opts, "decode_threads", nullptr, 0);  // remove
  }
  int rc = avformat_open_input(&d->fmt, url, nullptr, &opts);
  if (rc < 0) {
    set_averr(err, errcap, rc);
    av_dict_free(&opts);
    delete d;
    return nullptr;
  }
  if (unconsumed_user_option(opts, options, err, errcap)) {
    av_dict_free(&opts);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  av_dict_free(&opts);
  rc = avformat_find_stream_info(d->fmt, nullptr);
  if (rc < 0) {
    set_averr(err, errcap, rc);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->vstream =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (d->vstream < 0) {
    set_err(err, errcap, "no video stream");
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  // Audio rides along when the camera has a mic (reference intent:
  // rtsp_to_rtmp.py:66-68 detects streams.audio[0] and threads it into
  // the RTMP relay and MP4 archive). Absent audio is the common case.
  d->astream =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (d->astream < 0) d->astream = -1;
  d->pkt = av_packet_alloc();
  return d;
}

int va_stream_info(void* h, VAStreamInfo* out) {
  Demux* d = (Demux*)h;
  const AVStream* st = d->fmt->streams[d->vstream];
  const AVCodecParameters* par = st->codecpar;
  out->width = par->width;
  out->height = par->height;
  out->codec_id = (int32_t)par->codec_id;
  out->tb_num = st->time_base.num;
  out->tb_den = st->time_base.den;
  AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  out->fps_num = fr.num;
  out->fps_den = fr.den ? fr.den : 1;
  out->extradata_len = par->extradata_size;
  out->sample_rate = 0;
  out->channels = 0;
  const char* name = avcodec_get_name(par->codec_id);
  std::snprintf(out->codec_name, sizeof out->codec_name, "%s", name);
  return 0;
}

// Audio stream parameters, when the source has one. Returns 0 and fills
// `out`, or -1 when there is no audio stream.
int va_audio_info(void* h, VAStreamInfo* out) {
  Demux* d = (Demux*)h;
  if (d->astream < 0) return -1;
  const AVStream* st = d->fmt->streams[d->astream];
  const AVCodecParameters* par = st->codecpar;
  std::memset(out, 0, sizeof *out);
  out->codec_id = (int32_t)par->codec_id;
  out->tb_num = st->time_base.num;
  out->tb_den = st->time_base.den;
  out->extradata_len = par->extradata_size;
  out->sample_rate = par->sample_rate;
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 28, 100)
  out->channels = par->ch_layout.nb_channels;
#else
  out->channels = par->channels;
#endif
  const char* name = avcodec_get_name(par->codec_id);
  std::snprintf(out->codec_name, sizeof out->codec_name, "%s", name);
  return 0;
}

// Copy codec extradata (e.g. h264 avcC) used by stream-copy muxing.
int va_extradata(void* h, uint8_t* buf, int cap) {
  Demux* d = (Demux*)h;
  const AVCodecParameters* par = d->fmt->streams[d->vstream]->codecpar;
  if (par->extradata_size > cap) return AVERROR(ENOSPC);
  if (par->extradata_size > 0) std::memcpy(buf, par->extradata, par->extradata_size);
  return par->extradata_size;
}

// Audio extradata (e.g. AAC AudioSpecificConfig) for stream-copy muxing.
int va_audio_extradata(void* h, uint8_t* buf, int cap) {
  Demux* d = (Demux*)h;
  if (d->astream < 0) return -1;
  const AVCodecParameters* par = d->fmt->streams[d->astream]->codecpar;
  if (par->extradata_size > cap) return AVERROR(ENOSPC);
  if (par->extradata_size > 0) std::memcpy(buf, par->extradata, par->extradata_size);
  return par->extradata_size;
}

// Demux the next packet of the video OR audio stream. NO codec work
// happens here — this is the cheap phase of the reference's lazy-decode
// split (rtsp_to_rtmp.py:141-153); audio packets (meta->is_audio) exist
// only for the stream-copy consumers (archive mux, RTMP relay — the
// audio carry-through of rtsp_to_rtmp.py:87-89,170-180 and
// archive.py:78-96). 0 = packet ready, VA_EOF = end, <0 = error.
int va_read(void* h, VAPacketMeta* meta) {
  Demux* d = (Demux*)h;
  while (true) {
    av_packet_unref(d->pkt);
    d->pkt_valid = false;
    int rc = av_read_frame(d->fmt, d->pkt);
    if (rc == AVERROR_EOF) return VA_EOF;
    if (rc < 0) return rc;
    if (d->pkt->stream_index != d->vstream &&
        d->pkt->stream_index != d->astream)
      continue;
    d->pkt_valid = true;
    d->pkt_sent = false;
    if (meta) {
      meta->pts = d->pkt->pts;
      meta->dts = d->pkt->dts;
      meta->duration = d->pkt->duration;
      meta->size = d->pkt->size;
      meta->is_keyframe = (d->pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
      meta->is_corrupt = (d->pkt->flags & AV_PKT_FLAG_CORRUPT) ? 1 : 0;
      meta->is_audio = d->pkt->stream_index == d->astream ? 1 : 0;
    }
    return 0;
  }
}

// Copy the current packet's compressed payload (GOP buffering for archive /
// RTMP pass-through — the bytes the reference hands to its muxers).
int va_pkt_data(void* h, uint8_t* buf, int cap) {
  Demux* d = (Demux*)h;
  if (!d->pkt_valid) return AVERROR(EINVAL);
  if (d->pkt->size > cap) return AVERROR(ENOSPC);
  std::memcpy(buf, d->pkt->data, d->pkt->size);
  return d->pkt->size;
}

// Decode the current packet to BGR24. Opens the decoder lazily on first use.
// Returns bytes written (w*h*3) when a frame came out, 0 when the codec
// needs more input (delay / mid-GOP join), <0 on error. A mid-GOP join after
// idle demuxing produces 0s (h264 waits for an IDR) — the decode-from-GOP-
// head semantics the reference gets by clearing its queue at keyframes
// (rtsp_to_rtmp.py:155-157).
int va_decode(void* h, uint8_t* out, int64_t cap, VAFrameMeta* fm) {
  Demux* d = (Demux*)h;
  if (!d->dec) {
    int rc = open_decoder(d);
    if (rc < 0) return rc;
  }
  if (d->frame_pending) {  // retry after ENOSPC: frame already dequeued
    return frame_to_bgr(d, out, cap, fm);
  }
  // Only VIDEO packets feed the decoder; a current audio packet behaves
  // like "no packet" (drain any delayed frames, else 0).
  bool feedable = d->pkt_valid && !d->pkt_sent &&
                  d->pkt->stream_index == d->vstream;
  if (feedable) {
    int rc = avcodec_send_packet(d->dec, d->pkt);
    if (rc == 0 || rc == AVERROR_INVALIDDATA) {
      d->pkt_sent = true;
    } else if (rc != AVERROR(EAGAIN)) {
      return rc;
    }
    // EAGAIN: output queue full (multi-frame packets, e.g. PAFF fields).
    // pkt_sent stays false — receive below frees a slot, then retry, so
    // the packet's data is never silently dropped.
  }
  int rc = avcodec_receive_frame(d->dec, d->frame);
  if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
  if (rc < 0) return rc;
  if (feedable && !d->pkt_sent) {
    int rc2 = avcodec_send_packet(d->dec, d->pkt);
    if (rc2 == 0 || rc2 == AVERROR_INVALIDDATA) d->pkt_sent = true;
  }
  return frame_to_bgr(d, out, cap, fm);
}

// Flush the decoder at EOF (delayed frames). Same returns as va_decode.
int va_decode_drain(void* h, uint8_t* out, int64_t cap, VAFrameMeta* fm) {
  Demux* d = (Demux*)h;
  if (!d->dec) return 0;
  if (d->frame_pending) {  // retry after ENOSPC: frame already dequeued
    return frame_to_bgr(d, out, cap, fm);
  }
  avcodec_send_packet(d->dec, nullptr);
  int rc = avcodec_receive_frame(d->dec, d->frame);
  if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
  if (rc < 0) return rc;
  return frame_to_bgr(d, out, cap, fm);
}

void va_close(void* h) {
  Demux* d = (Demux*)h;
  if (!d) return;
  if (d->sws) sws_freeContext(d->sws);
  if (d->frame) av_frame_free(&d->frame);
  if (d->dec) avcodec_free_context(&d->dec);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ------------------------------------------------------------------ mux --

// Open a stream-copy muxer: MP4 archive segments (reference
// python/archive.py:75-100) or FLV/RTMP relay (rtsp_to_rtmp.py:163-182).
// `si` describes the *input* packets (codec, geometry, and the time base
// pts/dts handed to vm_write are in); format is guessed from url when
// null. `asi` (nullable) adds an audio stream — the reference's audio
// carry-through (archive.py:78-79, rtsp_to_rtmp.py:87-89); its packets go
// through vm_write_audio in the `asi` time base. `options` is an optional
// "k=v:k=v" AVOption string (e.g. "rtsp_flags=listen" turns the RTSP
// muxer into a one-client server — how the tests stand up a real rtsp://
// camera).
void* vm_open(const char* url, const char* format, const VAStreamInfo* si,
              const uint8_t* extradata, int extralen,
              const VAStreamInfo* asi, const uint8_t* a_extradata,
              int a_extralen, const char* options, char* err, int errcap) {
  net_init();
  Mux* m = new Mux();
  int rc = avformat_alloc_output_context2(&m->fmt, nullptr,
                                          (format && *format) ? format : nullptr,
                                          url);
  if (rc < 0 || !m->fmt) {
    set_averr(err, errcap, rc < 0 ? rc : AVERROR(EINVAL));
    delete m;
    return nullptr;
  }
  m->st = avformat_new_stream(m->fmt, nullptr);
  if (!m->st) {
    set_err(err, errcap, "failed to allocate stream");
    avformat_free_context(m->fmt);
    delete m;
    return nullptr;
  }
  AVCodecParameters* par = m->st->codecpar;
  par->codec_type = AVMEDIA_TYPE_VIDEO;
  par->codec_id = (AVCodecID)si->codec_id;
  par->width = si->width;
  par->height = si->height;
  if (extralen > 0) {
    par->extradata = (uint8_t*)av_mallocz(extralen + AV_INPUT_BUFFER_PADDING_SIZE);
    if (!par->extradata) {
      set_err(err, errcap, "failed to allocate video extradata");
      avformat_free_context(m->fmt);
      delete m;
      return nullptr;
    }
    std::memcpy(par->extradata, extradata, extralen);
    par->extradata_size = extralen;
  }
  m->in_tb = {si->tb_num, si->tb_den ? si->tb_den : 90000};
  m->st->time_base = m->in_tb;  // muxer may override in write_header
  if (asi) {
    m->ast = avformat_new_stream(m->fmt, nullptr);
    if (!m->ast) {
      set_err(err, errcap, "failed to allocate audio stream");
      avformat_free_context(m->fmt);
      delete m;
      return nullptr;
    }
    AVCodecParameters* apar = m->ast->codecpar;
    apar->codec_type = AVMEDIA_TYPE_AUDIO;
    apar->codec_id = (AVCodecID)asi->codec_id;
    apar->sample_rate = asi->sample_rate;
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 28, 100)
    av_channel_layout_default(&apar->ch_layout,
                              asi->channels > 0 ? asi->channels : 2);
#else
    apar->channels = asi->channels > 0 ? asi->channels : 2;
    apar->channel_layout = av_get_default_channel_layout(apar->channels);
#endif
    if (a_extralen > 0) {
      apar->extradata =
          (uint8_t*)av_mallocz(a_extralen + AV_INPUT_BUFFER_PADDING_SIZE);
      if (!apar->extradata) {
        set_err(err, errcap, "failed to allocate audio extradata");
        avformat_free_context(m->fmt);
        delete m;
        return nullptr;
      }
      std::memcpy(apar->extradata, a_extradata, a_extralen);
      apar->extradata_size = a_extralen;
    }
    m->in_atb = {asi->tb_num, asi->tb_den ? asi->tb_den : 48000};
    m->ast->time_base = m->in_atb;
  }
  AVDictionary* opts = nullptr;
  if (options && *options) {
    int prc = av_dict_parse_string(&opts, options, "=", ":", 0);
    if (prc < 0) {
      set_err(err, errcap, "malformed options string (want k=v:k=v)");
      av_dict_free(&opts);
      avformat_free_context(m->fmt);
      delete m;
      return nullptr;
    }
  }
  if (!(m->fmt->oformat->flags & AVFMT_NOFILE)) {
    rc = avio_open2(&m->fmt->pb, url, AVIO_FLAG_WRITE, nullptr, &opts);
    if (rc < 0) {
      set_averr(err, errcap, rc);
      av_dict_free(&opts);
      avformat_free_context(m->fmt);
      delete m;
      return nullptr;
    }
  }
  rc = avformat_write_header(m->fmt, &opts);
  if (rc >= 0 && unconsumed_user_option(opts, options, err, errcap)) {
    av_dict_free(&opts);
    if (!(m->fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&m->fmt->pb);
    avformat_free_context(m->fmt);
    delete m;
    return nullptr;
  }
  av_dict_free(&opts);
  if (rc < 0) {
    set_averr(err, errcap, rc);
    if (!(m->fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&m->fmt->pb);
    avformat_free_context(m->fmt);
    delete m;
    return nullptr;
  }
  m->header = true;
  return m;
}

namespace {

int mux_write_stream(Mux* m, AVStream* st, AVRational in_tb,
                     const uint8_t* data, int size, int64_t pts, int64_t dts,
                     int64_t duration, int keyframe) {
  AVPacket* pkt = av_packet_alloc();
  if (!pkt) return AVERROR(ENOMEM);
  uint8_t* buf = (uint8_t*)av_malloc(size + AV_INPUT_BUFFER_PADDING_SIZE);
  if (!buf) {
    av_packet_free(&pkt);
    return AVERROR(ENOMEM);
  }
  std::memcpy(buf, data, size);
  std::memset(buf + size, 0, AV_INPUT_BUFFER_PADDING_SIZE);
  int rc = av_packet_from_data(pkt, buf, size);
  if (rc < 0) {
    av_free(buf);
    av_packet_free(&pkt);
    return rc;
  }
  pkt->pts = pts;
  pkt->dts = dts;
  pkt->duration = duration;
  pkt->stream_index = st->index;
  if (keyframe) pkt->flags |= AV_PKT_FLAG_KEY;
  av_packet_rescale_ts(pkt, in_tb, st->time_base);
  rc = av_interleaved_write_frame(m->fmt, pkt);
  av_packet_free(&pkt);
  return rc;
}

}  // namespace

// Write one compressed VIDEO packet (pts/dts/duration in the time base
// given at vm_open). Stream copy: no codec work.
int vm_write(void* h, const uint8_t* data, int size, int64_t pts, int64_t dts,
             int64_t duration, int keyframe) {
  Mux* m = (Mux*)h;
  return mux_write_stream(m, m->st, m->in_tb, data, size, pts, dts, duration,
                          keyframe);
}

// Write one compressed AUDIO packet (pts/dts/duration in the `asi` time
// base given at vm_open). Returns EINVAL when the muxer has no audio
// stream.
int vm_write_audio(void* h, const uint8_t* data, int size, int64_t pts,
                   int64_t dts, int64_t duration) {
  Mux* m = (Mux*)h;
  if (!m->ast) return AVERROR(EINVAL);
  // Audio packets are all sync points; KEY keeps downstream demuxers happy.
  return mux_write_stream(m, m->ast, m->in_atb, data, size, pts, dts,
                          duration, /*keyframe=*/1);
}

int vm_close(void* h) {
  Mux* m = (Mux*)h;
  if (!m) return 0;
  int rc = 0;
  if (m->header) rc = av_write_trailer(m->fmt);
  if (m->fmt && !(m->fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&m->fmt->pb);
  if (m->fmt) avformat_free_context(m->fmt);
  delete m;
  return rc;
}

// --------------------------------------------------------------- encode --

// BGR24 encoder (test fixtures; re-encode fallback). global_header=1 emits
// extradata for MP4/FLV muxing instead of in-band headers.
void* vc_open(const char* codec_name, int w, int h, int fps_num, int fps_den,
              int gop, int64_t bitrate, int global_header, char* err,
              int errcap) {
  const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) {
    set_err(err, errcap, "encoder not found");
    return nullptr;
  }
  Enc* e = new Enc();
  e->ctx = avcodec_alloc_context3(codec);
  e->ctx->width = w;
  e->ctx->height = h;
  e->ctx->time_base = {fps_den, fps_num};
  e->ctx->framerate = {fps_num, fps_den};
  e->ctx->pix_fmt = AV_PIX_FMT_YUV420P;
  e->ctx->gop_size = gop;
  e->ctx->max_b_frames = 0;  // archive/relay want decode-order == pts-order
  if (bitrate > 0) e->ctx->bit_rate = bitrate;
  if (global_header) e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  AVDictionary* opts = nullptr;
  if (std::strcmp(codec_name, "libx264") == 0) {
    av_dict_set(&opts, "preset", "veryfast", 0);
    av_dict_set(&opts, "tune", "zerolatency", 0);
    // Deterministic GOP structure: keyframes exactly every gop frames
    // (fixture tests assert cadence; relay wants predictable IDR spacing).
    char params[96];
    std::snprintf(params, sizeof params,
                  "keyint=%d:min-keyint=%d:scenecut=0", gop, gop);
    av_dict_set(&opts, "x264-params", params, 0);
  }
  int rc = avcodec_open2(e->ctx, codec, &opts);
  av_dict_free(&opts);
  if (rc < 0) {
    set_averr(err, errcap, rc);
    avcodec_free_context(&e->ctx);
    delete e;
    return nullptr;
  }
  e->frame = av_frame_alloc();
  if (!e->frame) {
    set_averr(err, errcap, AVERROR(ENOMEM));
    avcodec_free_context(&e->ctx);
    delete e;
    return nullptr;
  }
  e->frame->format = AV_PIX_FMT_YUV420P;
  e->frame->width = w;
  e->frame->height = h;
  rc = av_frame_get_buffer(e->frame, 0);
  if (rc < 0) {
    // Unchecked, vc_send would memcpy into null data planes.
    set_averr(err, errcap, rc);
    av_frame_free(&e->frame);
    avcodec_free_context(&e->ctx);
    delete e;
    return nullptr;
  }
  e->pkt = av_packet_alloc();
  return e;
}

int vc_info(void* h, VAStreamInfo* out) {
  Enc* e = (Enc*)h;
  std::memset(out, 0, sizeof *out);
  out->width = e->ctx->width;
  out->height = e->ctx->height;
  out->codec_id = (int32_t)e->ctx->codec_id;
  out->tb_num = e->ctx->time_base.num;
  out->tb_den = e->ctx->time_base.den;
  out->fps_num = e->ctx->framerate.num;
  out->fps_den = e->ctx->framerate.den;
  out->extradata_len = e->ctx->extradata_size;
  std::snprintf(out->codec_name, sizeof out->codec_name, "%s",
                avcodec_get_name(e->ctx->codec_id));
  return 0;
}

int vc_extradata(void* h, uint8_t* buf, int cap) {
  Enc* e = (Enc*)h;
  if (e->ctx->extradata_size > cap) return AVERROR(ENOSPC);
  if (e->ctx->extradata_size > 0)
    std::memcpy(buf, e->ctx->extradata, e->ctx->extradata_size);
  return e->ctx->extradata_size;
}

// Send one BGR24 frame (null = begin flush). pts < 0 auto-increments.
int vc_send(void* h, const uint8_t* bgr, int64_t pts) {
  Enc* e = (Enc*)h;
  if (!bgr) return avcodec_send_frame(e->ctx, nullptr);
  const int w = e->ctx->width, hh = e->ctx->height;
  e->sws = sws_getCachedContext(e->sws, w, hh, AV_PIX_FMT_BGR24, w, hh,
                                AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                                nullptr, nullptr);
  if (!e->sws) return AVERROR(EINVAL);
  int rc = av_frame_make_writable(e->frame);
  if (rc < 0) return rc;
  const uint8_t* src[4] = {bgr, nullptr, nullptr, nullptr};
  int src_stride[4] = {3 * w, 0, 0, 0};
  sws_scale(e->sws, src, src_stride, 0, hh, e->frame->data, e->frame->linesize);
  e->frame->pts = pts >= 0 ? pts : e->next_pts;
  e->next_pts = e->frame->pts + 1;
  return avcodec_send_frame(e->ctx, e->frame);
}

// Receive one encoded packet: size on success, 0 when the encoder needs
// more input, VA_EOF when fully flushed, <0 on error.
int vc_receive(void* h, VAPacketMeta* meta, uint8_t* buf, int cap) {
  Enc* e = (Enc*)h;
  int rc = avcodec_receive_packet(e->ctx, e->pkt);
  if (rc == AVERROR(EAGAIN)) return 0;
  if (rc == AVERROR_EOF) return VA_EOF;
  if (rc < 0) return rc;
  if (e->pkt->size > cap) {
    av_packet_unref(e->pkt);
    return AVERROR(ENOSPC);
  }
  std::memcpy(buf, e->pkt->data, e->pkt->size);
  if (meta) {
    meta->pts = e->pkt->pts;
    meta->dts = e->pkt->dts;
    meta->duration = e->pkt->duration;
    meta->size = e->pkt->size;
    meta->is_keyframe = (e->pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
    meta->is_corrupt = 0;
  }
  int size = e->pkt->size;
  av_packet_unref(e->pkt);
  return size;
}

void vc_close(void* h) {
  Enc* e = (Enc*)h;
  if (!e) return;
  if (e->sws) sws_freeContext(e->sws);
  if (e->frame) av_frame_free(&e->frame);
  if (e->pkt) av_packet_free(&e->pkt);
  if (e->ctx) avcodec_free_context(&e->ctx);
  delete e;
}

// ---------------------------------------------------------- audio encode --

// Audio encoder (AAC by default): interleaved float PCM in, compressed
// packets out. Exists for the audio-bearing test fixtures (no ffmpeg CLI
// in this image) and re-encode fallbacks — the camera path itself is
// always stream copy.

struct AEnc {
  AVCodecContext* ctx = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int64_t next_pts = 0;
};

void* vca_open(const char* codec_name, int sample_rate, int channels,
               char* err, int errcap) {
  const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
  if (!codec) {
    set_err(err, errcap, "audio encoder not found");
    return nullptr;
  }
  AEnc* e = new AEnc();
  e->ctx = avcodec_alloc_context3(codec);
  e->ctx->sample_rate = sample_rate;
  e->ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;  // ffmpeg native aac format
  e->ctx->time_base = {1, sample_rate};
  e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;  // extradata for MP4/FLV
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 28, 100)
  av_channel_layout_default(&e->ctx->ch_layout, channels);
#else
  e->ctx->channels = channels;
  e->ctx->channel_layout = av_get_default_channel_layout(channels);
#endif
  int rc = avcodec_open2(e->ctx, codec, nullptr);
  if (rc < 0) {
    set_averr(err, errcap, rc);
    avcodec_free_context(&e->ctx);
    delete e;
    return nullptr;
  }
  e->frame = av_frame_alloc();
  if (!e->frame) {
    set_averr(err, errcap, AVERROR(ENOMEM));
    avcodec_free_context(&e->ctx);
    delete e;
    return nullptr;
  }
  e->frame->format = AV_SAMPLE_FMT_FLTP;
  e->frame->nb_samples = e->ctx->frame_size ? e->ctx->frame_size : 1024;
  e->frame->sample_rate = sample_rate;
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 28, 100)
  av_channel_layout_copy(&e->frame->ch_layout, &e->ctx->ch_layout);
#else
  e->frame->channels = channels;
  e->frame->channel_layout = e->ctx->channel_layout;
#endif
  rc = av_frame_get_buffer(e->frame, 0);
  if (rc < 0) {
    set_averr(err, errcap, rc);
    av_frame_free(&e->frame);
    avcodec_free_context(&e->ctx);
    delete e;
    return nullptr;
  }
  e->pkt = av_packet_alloc();
  return e;
}

// Samples per frame the encoder expects in each vca_send (AAC: 1024).
int vca_frame_size(void* h) {
  AEnc* e = (AEnc*)h;
  return e->ctx->frame_size ? e->ctx->frame_size : 1024;
}

int vca_info(void* h, VAStreamInfo* out) {
  AEnc* e = (AEnc*)h;
  std::memset(out, 0, sizeof *out);
  out->codec_id = (int32_t)e->ctx->codec_id;
  out->tb_num = 1;
  out->tb_den = e->ctx->sample_rate;
  out->sample_rate = e->ctx->sample_rate;
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 28, 100)
  out->channels = e->ctx->ch_layout.nb_channels;
#else
  out->channels = e->ctx->channels;
#endif
  out->extradata_len = e->ctx->extradata_size;
  std::snprintf(out->codec_name, sizeof out->codec_name, "%s",
                avcodec_get_name(e->ctx->codec_id));
  return 0;
}

int vca_extradata(void* h, uint8_t* buf, int cap) {
  AEnc* e = (AEnc*)h;
  if (e->ctx->extradata_size > cap) return AVERROR(ENOSPC);
  if (e->ctx->extradata_size > 0)
    std::memcpy(buf, e->ctx->extradata, e->ctx->extradata_size);
  return e->ctx->extradata_size;
}

// Send vca_frame_size() samples of interleaved float PCM (null = begin
// flush). pts < 0 auto-increments in samples.
int vca_send(void* h, const float* interleaved, int64_t pts) {
  AEnc* e = (AEnc*)h;
  if (!interleaved) return avcodec_send_frame(e->ctx, nullptr);
  int rc = av_frame_make_writable(e->frame);
  if (rc < 0) return rc;
#if LIBAVUTIL_VERSION_INT >= AV_VERSION_INT(57, 28, 100)
  const int ch = e->ctx->ch_layout.nb_channels;
#else
  const int ch = e->ctx->channels;
#endif
  const int n = e->frame->nb_samples;
  for (int c = 0; c < ch; ++c) {
    float* plane = (float*)e->frame->data[c];
    for (int i = 0; i < n; ++i) plane[i] = interleaved[i * ch + c];
  }
  e->frame->pts = pts >= 0 ? pts : e->next_pts;
  e->next_pts = e->frame->pts + n;
  return avcodec_send_frame(e->ctx, e->frame);
}

// Receive one encoded packet: size on success, 0 when the encoder needs
// more input, VA_EOF when fully flushed, <0 on error.
int vca_receive(void* h, VAPacketMeta* meta, uint8_t* buf, int cap) {
  AEnc* e = (AEnc*)h;
  int rc = avcodec_receive_packet(e->ctx, e->pkt);
  if (rc == AVERROR(EAGAIN)) return 0;
  if (rc == AVERROR_EOF) return VA_EOF;
  if (rc < 0) return rc;
  if (e->pkt->size > cap) {
    av_packet_unref(e->pkt);
    return AVERROR(ENOSPC);
  }
  std::memcpy(buf, e->pkt->data, e->pkt->size);
  if (meta) {
    meta->pts = e->pkt->pts;
    meta->dts = e->pkt->dts;
    meta->duration = e->pkt->duration;
    meta->size = e->pkt->size;
    meta->is_keyframe = 1;
    meta->is_corrupt = 0;
    meta->is_audio = 1;
  }
  int size = e->pkt->size;
  av_packet_unref(e->pkt);
  return size;
}

void vca_close(void* h) {
  AEnc* e = (AEnc*)h;
  if (!e) return;
  if (e->frame) av_frame_free(&e->frame);
  if (e->pkt) av_packet_free(&e->pkt);
  if (e->ctx) avcodec_free_context(&e->ctx);
  delete e;
}

// ---------------------------------------------------------------- misc --

int va_encoder_available(const char* name) {
  return avcodec_find_encoder_by_name(name) ? 1 : 0;
}

// Default AV_LOG_ERROR: codec banners/stats would otherwise interleave with
// every worker's stdout (the reference's conda ffmpeg is equally chatty but
// hidden inside containers).
void va_set_log_level(int level) { av_log_set_level(level); }

void va_strerror(int code, char* buf, int cap) { av_strerror(code, buf, cap); }

}  // extern "C"
