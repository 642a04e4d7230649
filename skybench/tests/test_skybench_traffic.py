"""The request generator: the seed alone decides the requests."""
import json

from skybench import spec, traffic


def _mix(name, seed):
    return traffic.Mix(spec.load_json(
        spec.HERE / "traffic" / f"{name}.json"), seed)


def test_same_seed_same_requests():
    a = _mix("rag-batch", 2**31 + 17).requests(300, "window")
    b = _mix("rag-batch", 2**31 + 17).requests(300, "window")
    assert a == b
    # another stream of the same seed (the warm-up's...) differs
    assert a != _mix("rag-batch", 2**31 + 17).requests(300, "other")


def test_seeds_ask_the_same_work_in_another_order():
    a = _mix("rag-batch", 3).requests(400, "window")
    b = _mix("rag-batch", 2**33 + 1).requests(400, "window")
    assert [r.text for r in a] != [r.text for r in b]
    for f in (lambda r: r.max_new_tokens, lambda r: len(r.text)):
        assert sorted(map(f, a)) == sorted(map(f, b))
        assert list(map(f, a)) != list(map(f, b))


def test_sizes_follow_the_traffic_file():
    p = spec.load_json(spec.HERE / "traffic" / "rag-batch.json")
    mix = traffic.Mix(p, 11)
    reqs = mix.requests(500, "window")
    for r in reqs:
        n = len(traffic.token_ids(r.text))
        q = n - p["document_tokens"]
        assert p["question_tokens"][0] <= q <= p["question_tokens"][1]
        a = p["answer_tokens"]
        assert a["min"] <= r.max_new_tokens <= a["max"]
        assert r.text.startswith(mix.documents[r.doc])
    # Zipf: the most popular document is asked about most
    counts = [sum(r.doc == d for r in reqs) for d in range(p["documents"])]
    assert max(counts) == counts[mix.doc_of_rank[0]]
    assert len({r.text for r in reqs}) == len(reqs)
    json.dumps([r.text for r in reqs])      # plain ASCII text
