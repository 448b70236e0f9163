"""File extensions and command ranks.

Mirrors the reference contract in reference src/constant.h:6-30.
"""

SAI_EXT = ".sai"
RSAI_EXT = ".rsai"
BWT_EXT = ".bwt"
RBWT_EXT = ".rbwt"
ASQG_EXT = ".asqg"
HITS_EXT = ".hits"
GZIP_EXT = ".gz"
BZIP_EXT = ".bz2"
RMDUP_EXT = ".rmdup"
EC_EXT = ".ec"
FA_EXT = ".fa"

# command ordering for help output
COMMAND_RANKS = {
    "preprocess": 0,
    "index": 1,
    "correct": 2,
    "overlap": 3,
    "assemble": 4,
    "subgraph": 5,
    "rmdup": 6,
    "preqc": 7,
    "match": 8,
    "gan": 1000,  # hidden
}
