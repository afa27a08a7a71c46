#!/bin/bash
# Build the native host library (BGZF/BAM decoder and friends) for this
# machine's CPU. Prints whether libdeflate was linked.
set -e
cd "$(dirname "$0")/.."
SRC=strawberry_tpu/native
OUT=$SRC/libstrawberry_host.so
# libdeflate (2-3x faster BGZF inflate) is optional; bamdecode.cc falls
# back to zlib when the header is absent
EXTRA=""
DEFLATE=no
if echo '#include <libdeflate.h>' | g++ -E -x c++ - >/dev/null 2>&1; then
  EXTRA="-ldeflate"
  DEFLATE=yes
fi
# build beside the target and rename: a process loading the library never
# sees a half-written file
TMP=$(mktemp "$OUT.XXXXXX")
g++ -std=c++17 -O3 -march=native -fPIC -shared -pthread \
    $SRC/bamdecode.cc $SRC/cluster.cc $SRC/compat.cc $SRC/quantprep.cc $SRC/mcf.cc $SRC/em.cc $SRC/assembleprep.cc $SRC/lemonns.cc $SRC/gffparse.cc $SRC/gtfemit.cc \
    -lz $EXTRA -o "$TMP"
chmod 755 "$TMP"
mv -f "$TMP" "$OUT"
echo "built $OUT (libdeflate: $DEFLATE)"
