#!/bin/sh
# Build the native IO runtime from ofri_io.cpp.
#   sh build.sh OUTPUT.so
set -e
cd "$(dirname "$0")"
g++ -O2 -shared -fPIC -std=c++17 -pthread -o "$1" ofri_io.cpp
