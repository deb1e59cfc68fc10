"""The port's shuffle plane: the manager and handle, the record writers
and readers, the fetcher, push/merge, columnar blocks, the device IO
path, the reduce-side device fetch (the arena registry and the wave
compiler) and the SPMD TeraSort's range planning."""
