#!/bin/sh
# Build the native BVH builder shared library (native/libbvh.so).
# accel/native_builder.py runs this on first use; running it by hand is
# only needed to rebuild ahead of time. The output is written under a
# temporary name and renamed, so concurrent builds never expose a partial
# library. No -march=native: the library must load on any x86-64 host.
set -e
cd "$(dirname "$0")"
tmp="libbvh.so.tmp.$$"
g++ -O2 -fPIC -shared -o "$tmp" bvh_builder.cpp
mv -f "$tmp" libbvh.so
echo "built $(pwd)/libbvh.so"
