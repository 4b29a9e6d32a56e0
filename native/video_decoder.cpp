// FFmpeg-backed indexed video decoder for the fitclip_tpu input pipeline.
//
// The equivalent of the reference's decord dependency
// (aligner/data/video_reader.py:42-85 + SURVEY §2.9): open -> build a frame
// index (pts per frame, keyframe flags) -> decode arbitrary frame indices as
// RGB24 (optionally swscale-resized while decoding) -> expose frame-midpoint
// timestamps for time->index seeks. Exposed as a C ABI for ctypes.
//
// Build: see native/Makefile (links libavformat/libavcodec/libavutil/libswscale).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct FrameIndex {
  std::vector<int64_t> pts;       // sorted presentation timestamps
  std::vector<uint8_t> keyframe;  // parallel to pts
};

struct Decoder {
  AVFormatContext* format_ctx = nullptr;
  AVCodecContext* codec_ctx = nullptr;
  int stream_index = -1;
  FrameIndex index;
  double time_base = 0.0;   // seconds per pts unit
  double avg_fps = 0.0;
  int width = 0;
  int height = 0;
  int threads = 1;
  // Decode cursor: position of the next frame the decoder will output,
  // as an index into index.pts; -1 = unknown (must seek).
  int64_t next_frame = -1;
};

bool build_index(Decoder* d) {
  // Fast path: the container's own index (AVI idx1, MP4 stts/stss) is
  // loaded by the demuxer at open — reading it costs nothing, where the
  // demux pass below streams the whole file (~10 MB for a 4 s 720p MJPEG
  // clip) just to learn pts. Trust it only when it plausibly covers the
  // stream (>= nb_frames when the container declares a count, else > 1
  // entry and a duration that matches within half a frame).
  AVStream* stream = d->format_ctx->streams[d->stream_index];
  int n_entries = avformat_index_get_entries_count(stream);
  if (n_entries > 1) {
    int64_t declared = stream->nb_frames;
    bool covers = declared > 0 ? n_entries >= declared : false;
    if (!covers && declared <= 0 && stream->duration > 0 &&
        stream->avg_frame_rate.num > 0) {
      double dur_frames = stream->duration * av_q2d(stream->time_base) *
                          av_q2d(stream->avg_frame_rate);
      covers = n_entries >= dur_frames - 0.5;
    }
    if (covers) {
      std::vector<std::pair<int64_t, uint8_t>> entries;
      entries.reserve(n_entries);
      bool usable = true;
      for (int i = 0; i < n_entries; ++i) {
        const AVIndexEntry* e = avformat_index_get_entry(stream, i);
        if (!e || e->timestamp == AV_NOPTS_VALUE) { usable = false; break; }
        entries.emplace_back(e->timestamp,
                             (e->flags & AVINDEX_KEYFRAME) ? 1 : 0);
      }
      if (usable) {
        std::sort(entries.begin(), entries.end());
        for (auto& e : entries) {
          d->index.pts.push_back(e.first);
          d->index.keyframe.push_back(e.second);
        }
        d->next_frame = -1;  // decode cursor unknown until the first seek
        return true;
      }
      d->index.pts.clear();
      d->index.keyframe.clear();
    }
  }
  // One demux pass (no decode) collecting pts + keyframe flags, like decord.
  AVPacket* pkt = av_packet_alloc();
  std::vector<std::pair<int64_t, uint8_t>> entries;
  while (av_read_frame(d->format_ctx, pkt) >= 0) {
    if (pkt->stream_index == d->stream_index) {
      int64_t ts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      entries.emplace_back(ts, (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0);
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  if (entries.empty()) return false;
  std::sort(entries.begin(), entries.end());
  d->index.pts.reserve(entries.size());
  d->index.keyframe.reserve(entries.size());
  for (auto& e : entries) {
    d->index.pts.push_back(e.first);
    d->index.keyframe.push_back(e.second);
  }
  // Rewind for decoding.
  av_seek_frame(d->format_ctx, d->stream_index, d->index.pts.front(),
                AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(d->codec_ctx);
  d->next_frame = 0;
  return true;
}

int frame_position(const Decoder* d, int64_t pts) {
  auto it = std::lower_bound(d->index.pts.begin(), d->index.pts.end(), pts);
  if (it == d->index.pts.end()) return static_cast<int>(d->index.pts.size()) - 1;
  return static_cast<int>(it - d->index.pts.begin());
}

int prev_keyframe(const Decoder* d, int frame) {
  for (int i = frame; i >= 0; --i)
    if (d->index.keyframe[i]) return i;
  return 0;
}

}  // namespace

extern "C" {

// target_short_side > 0 enables decode-time downscaling: when the codec
// supports lowres (DCT-domain decode at 1/2^k scale — MJPEG and friends; a
// large fraction of the JPEG IDCT work simply never happens), pick the
// largest k that keeps the decoded short side >= target; the per-frame
// swscale pass then finishes the job at the (much smaller) decoded size.
// threads > 1 enables FRAME-level codec threading: with the batch packet
// feed in vd_get_frames, the sampled frames of an intra-only stream decode
// in parallel workers (the VERDICT r4 #5 keyframe-parallel lever — a
// per-clip LATENCY win on multi-core hosts; on a 1-core host it cannot
// beat threads=1, which stays the default for decord parity).
void* vd_open_threaded(const char* path, int target_short_side, int threads) {
  // Quiet libav chatter (e.g. swscale's per-frame deprecated-pixel-format
  // warning on yuvj streams); real failures surface as nullptr returns that
  // the Python layer logs and zero-fills.
  av_log_set_level(AV_LOG_ERROR);
  auto* d = new Decoder();
  d->threads = threads > 1 ? threads : 1;
  if (avformat_open_input(&d->format_ctx, path, nullptr, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->format_ctx, nullptr) < 0) {
    avformat_close_input(&d->format_ctx);
    delete d;
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  d->stream_index = av_find_best_stream(d->format_ctx, AVMEDIA_TYPE_VIDEO, -1,
                                        -1, &codec, 0);
  if (d->stream_index < 0 || !codec) {
    avformat_close_input(&d->format_ctx);
    delete d;
    return nullptr;
  }
  AVStream* stream = d->format_ctx->streams[d->stream_index];
  d->codec_ctx = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(d->codec_ctx, stream->codecpar);
  d->codec_ctx->thread_count = d->threads;  // 1 = decord parity default
  if (d->threads > 1) d->codec_ctx->thread_type = FF_THREAD_FRAME;
  // vd_frame_size reports NATIVE geometry (from the container) regardless of
  // any lowres decode — callers compute output sizes from it.
  d->width = stream->codecpar->width;
  d->height = stream->codecpar->height;
  if (target_short_side > 0 && codec->max_lowres > 0) {
    int short_side = std::min(d->width, d->height);
    int lowres = 0;
    while (lowres < codec->max_lowres &&
           (short_side >> (lowres + 1)) >= target_short_side) {
      ++lowres;
    }
    d->codec_ctx->lowres = lowres;
  }
  if (avcodec_open2(d->codec_ctx, codec, nullptr) < 0) {
    avcodec_free_context(&d->codec_ctx);
    avformat_close_input(&d->format_ctx);
    delete d;
    return nullptr;
  }
  d->time_base = av_q2d(stream->time_base);
  d->avg_fps = stream->avg_frame_rate.den
                   ? av_q2d(stream->avg_frame_rate)
                   : 0.0;
  if (!build_index(d)) {
    avcodec_free_context(&d->codec_ctx);
    avformat_close_input(&d->format_ctx);
    delete d;
    return nullptr;
  }
  if (d->avg_fps <= 0.0 && d->index.pts.size() > 1) {
    double duration = (d->index.pts.back() - d->index.pts.front()) * d->time_base;
    if (duration > 0) d->avg_fps = (d->index.pts.size() - 1) / duration;
  }
  return d;
}

void* vd_open_scaled(const char* path, int target_short_side) {
  return vd_open_threaded(path, target_short_side, 1);
}

void* vd_open(const char* path) { return vd_open_threaded(path, 0, 1); }

int vd_num_frames(void* handle) {
  return static_cast<int>(static_cast<Decoder*>(handle)->index.pts.size());
}

double vd_avg_fps(void* handle) {
  return static_cast<Decoder*>(handle)->avg_fps;
}

void vd_frame_size(void* handle, int* height, int* width) {
  auto* d = static_cast<Decoder*>(handle);
  *height = d->height;
  *width = d->width;
}

// Per-frame keyframe flags (0/1), parallel to the frame index — exposes the
// GOP structure for the decode cost model (scripts/bench_decode.py).
void vd_keyframes(void* handle, uint8_t* out) {
  auto* d = static_cast<Decoder*>(handle);
  std::memcpy(out, d->index.keyframe.data(), d->index.keyframe.size());
}

// Frame midpoint timestamps in seconds (decord get_frame_timestamp mean
// semantics for constant-rate streams).
void vd_timestamps(void* handle, double* out) {
  auto* d = static_cast<Decoder*>(handle);
  size_t n = d->index.pts.size();
  double half_frame = d->avg_fps > 0 ? 0.5 / d->avg_fps : 0.0;
  int64_t start = d->index.pts.front();
  for (size_t i = 0; i < n; ++i)
    out[i] = (d->index.pts[i] - start) * d->time_base + half_frame;
}

// Decode `n` frame indices into `out` (n * out_h * out_w * 3, RGB24).
// out_h/out_w of 0 mean native size. Returns 0 on success.
int vd_get_frames(void* handle, const int64_t* indices, int n,
                  uint8_t* out, int out_h, int out_w) {
  auto* d = static_cast<Decoder*>(handle);
  if (out_h <= 0) out_h = d->height;
  if (out_w <= 0) out_w = d->width;
  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;

  // Decode each unique frame once.
  std::vector<int> unique;
  for (int i = 0; i < n; ++i) {
    int idx = static_cast<int>(indices[i]);
    if (idx < 0 || idx >= vd_num_frames(handle)) return -1;
    unique.push_back(idx);
  }
  std::sort(unique.begin(), unique.end());
  unique.erase(std::unique(unique.begin(), unique.end()), unique.end());

  std::map<int, std::vector<uint8_t>> decoded;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  SwsContext* sws = nullptr;
  int ret_code = 0;

  auto store_if_target = [&](AVFrame* f) {
    int64_t pts = f->best_effort_timestamp != AV_NOPTS_VALUE
                      ? f->best_effort_timestamp
                      : f->pts;
    int pos = frame_position(d, pts);
    if (!std::binary_search(unique.begin(), unique.end(), pos)) return;
    sws = sws_getCachedContext(sws, f->width, f->height,
                               static_cast<AVPixelFormat>(f->format),
                               out_w, out_h, AV_PIX_FMT_RGB24, SWS_BICUBIC,
                               nullptr, nullptr, nullptr);
    std::vector<uint8_t> rgb(frame_bytes);
    uint8_t* dst_data[4] = {rgb.data(), nullptr, nullptr, nullptr};
    int dst_linesize[4] = {out_w * 3, 0, 0, 0};
    sws_scale(sws, f->data, f->linesize, 0, f->height, dst_data, dst_linesize);
    decoded[pos] = std::move(rgb);
  };

  bool all_key = unique.size() > 1;
  for (int t : unique) all_key = all_key && d->index.keyframe[t];
  if (d->threads > 1 && all_key) {
    // Pipelined intra path (frame threading): seek to each target keyframe
    // and send ONLY its packet, then flush-drain once — the codec's frame
    // threads decode the n targets concurrently (no inter-frame deps on an
    // all-keyframe stream, so no buffer flush between seeks).
    for (int target : unique) {
      int64_t want = d->index.pts[target];
      av_seek_frame(d->format_ctx, d->stream_index, want,
                    AVSEEK_FLAG_BACKWARD);
      while (true) {
        int read = av_read_frame(d->format_ctx, pkt);
        if (read < 0) { ret_code = -2; break; }
        if (pkt->stream_index != d->stream_index) {
          av_packet_unref(pkt);
          continue;
        }
        int64_t ts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
        if (ts < want) {  // seek landed early; skip to the target packet
          av_packet_unref(pkt);
          continue;
        }
        avcodec_send_packet(d->codec_ctx, pkt);
        av_packet_unref(pkt);
        break;
      }
      if (ret_code != 0) break;
      while (avcodec_receive_frame(d->codec_ctx, frame) >= 0) {
        store_if_target(frame);
        av_frame_unref(frame);
      }
    }
    if (ret_code == 0) {
      avcodec_send_packet(d->codec_ctx, nullptr);
      while (avcodec_receive_frame(d->codec_ctx, frame) >= 0) {
        store_if_target(frame);
        av_frame_unref(frame);
      }
    }
    avcodec_flush_buffers(d->codec_ctx);  // leave the codec reusable post-EOF
    d->next_frame = -1;
    if (ret_code == 0 && decoded.size() != unique.size()) ret_code = -2;
    if (sws) sws_freeContext(sws);
    av_frame_free(&frame);
    av_packet_free(&pkt);
    if (ret_code != 0) return ret_code;
    for (int i = 0; i < n; ++i) {
      auto& rgb = decoded[static_cast<int>(indices[i])];
      std::memcpy(out + static_cast<size_t>(i) * frame_bytes, rgb.data(),
                  frame_bytes);
    }
    return 0;
  }

  for (int target : unique) {
    // Seek when behind the cursor, or when a keyframe sits between the
    // cursor and the target: decoding from that keyframe is strictly less
    // work than decoding every frame in between. For intra-only streams
    // (MJPEG — every frame a keyframe) this decodes EXACTLY the sampled
    // frames; the previous >256-gap heuristic decoded all ~30 in-between
    // frames per uniform-sampling gap (round-5 fix, measured in
    // scripts/bench_decode.py).
    int key = prev_keyframe(d, target);
    if (d->next_frame < 0 || target < d->next_frame || key > d->next_frame) {
      av_seek_frame(d->format_ctx, d->stream_index, d->index.pts[key],
                    AVSEEK_FLAG_BACKWARD);
      avcodec_flush_buffers(d->codec_ctx);
      d->next_frame = -2;  // unknown until the first decoded frame tells us
    }
    bool done = false;
    while (!done) {
      int read = av_read_frame(d->format_ctx, pkt);
      if (read < 0) {
        // Flush.
        avcodec_send_packet(d->codec_ctx, nullptr);
      } else if (pkt->stream_index != d->stream_index) {
        av_packet_unref(pkt);
        continue;
      } else {
        avcodec_send_packet(d->codec_ctx, pkt);
        av_packet_unref(pkt);
      }
      while (true) {
        int recv = avcodec_receive_frame(d->codec_ctx, frame);
        if (recv == AVERROR(EAGAIN)) break;
        if (recv < 0) { done = true; ret_code = read < 0 ? -2 : ret_code; break; }
        int64_t pts = frame->best_effort_timestamp != AV_NOPTS_VALUE
                          ? frame->best_effort_timestamp
                          : frame->pts;
        int pos = frame_position(d, pts);
        d->next_frame = pos + 1;
        if (pos == target) {
          sws = sws_getCachedContext(sws, frame->width, frame->height,
                                     static_cast<AVPixelFormat>(frame->format),
                                     out_w, out_h, AV_PIX_FMT_RGB24,
                                     SWS_BICUBIC, nullptr, nullptr, nullptr);
          std::vector<uint8_t> rgb(frame_bytes);
          uint8_t* dst_data[4] = {rgb.data(), nullptr, nullptr, nullptr};
          int dst_linesize[4] = {out_w * 3, 0, 0, 0};
          sws_scale(sws, frame->data, frame->linesize, 0, frame->height,
                    dst_data, dst_linesize);
          decoded[target] = std::move(rgb);
          av_frame_unref(frame);
          done = true;
          break;
        }
        av_frame_unref(frame);
      }
      if (read < 0 && !done) { done = true; ret_code = -2; }
    }
    if (decoded.find(target) == decoded.end()) { ret_code = -2; break; }
  }

  if (sws) sws_freeContext(sws);
  av_frame_free(&frame);
  av_packet_free(&pkt);

  if (ret_code != 0) return ret_code;
  for (int i = 0; i < n; ++i) {
    auto& rgb = decoded[static_cast<int>(indices[i])];
    std::memcpy(out + static_cast<size_t>(i) * frame_bytes, rgb.data(),
                frame_bytes);
  }
  return 0;
}

void vd_close(void* handle) {
  auto* d = static_cast<Decoder*>(handle);
  if (d->codec_ctx) avcodec_free_context(&d->codec_ctx);
  if (d->format_ctx) avformat_close_input(&d->format_ctx);
  delete d;
}

}  // extern "C"
