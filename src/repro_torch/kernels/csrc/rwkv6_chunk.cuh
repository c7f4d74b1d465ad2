// The WKV backward's checkpoint stride and row block, shared by the
// training forward that writes the checkpoints (rwkv6_wkv.cu, its
// checkpoint variant) and the backward that reads them (rwkv6_wkv_bwd.cu).
// kernels/rwkv6_scan.py's BWD_CHUNK and BWD_ROWS pass the same numbers to
// every launch, and the entry points refuse any others.
#pragma once

namespace rwkv6 {

// state rows a block of the backward (a head's row blocks form a cluster)
constexpr int kBwdRows = 16;

// steps between checkpoints: the backward keeps a chunk's recomputed states
// in shared memory, (chunk - 1) x 16 rows x (hd + 4) floats, ~32 KB
template <int HD>
constexpr int kBwdChunk = HD <= 32 ? 16 : 512 / HD;

}  // namespace rwkv6
