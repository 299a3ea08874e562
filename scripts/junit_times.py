"""Seconds of a pytest run by test file, from its JUnit XML (--junitxml).

    python3 scripts/junit_times.py run.xml [--match test_torch_]

Prints the run's totals (tests, failures, errors, skipped, the suite's
seconds), then each test file's summed test seconds and test count, largest
first, and their sum. Under pytest-xdist the sums are worker seconds: with
`--dist loadfile` a file's sum is how long it holds its worker.
"""
import argparse
import collections
import xml.etree.ElementTree as ET


def file_seconds(path, match=""):
    """({file: [seconds, tests]}, the testsuite's attributes) of a JUnit XML."""
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    per = collections.defaultdict(lambda: [0.0, 0])
    for case in suite.iter("testcase"):
        name = case.get("classname", "").split(".")
        # classname is tests.<module>[.<Class>]: the module names the file
        module = next((p for p in name if p.startswith("test_")), ".".join(name))
        if match not in module:
            continue
        per[module][0] += float(case.get("time", 0.0))
        per[module][1] += 1
    return dict(per), dict(suite.attrib)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--match", default="", help="keep the files whose name holds this")
    args = ap.parse_args()
    per, attrs = file_seconds(args.xml, args.match)
    print(" ".join(f"{k}={attrs.get(k)}" for k in ("tests", "failures", "errors", "skipped",
                                                   "time")))
    for module, (sec, n) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        print(f"{sec:10.1f} s {n:5d} tests  {module}.py")
    print(f"{sum(v[0] for v in per.values()):10.1f} s {sum(v[1] for v in per.values()):5d} "
          "tests  in all")


if __name__ == "__main__":
    main()
