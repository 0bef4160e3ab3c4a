import time

T_START = time.perf_counter()   # set-up is timed from here

if __name__ == "__main__":
    import sys

    from h100_bench.run import main

    sys.exit(main(t_start=T_START))
