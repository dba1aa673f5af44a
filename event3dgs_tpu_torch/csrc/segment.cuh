// The instance segments shared by the expansion kernel (csrc/expand.cu)
// and the counting sort (csrc/sort_tiles.cu): the expansion writes each
// segment's tile counts in the row layout the sort's scan reads, so both
// must cut the instance slots at the same boundaries.  Mirrored by
// ops/sort_tiles.py `SEGMENT`.
#pragma once

constexpr int SEGMENT = 2048;  // instance slots per segment
