"""Drive minio_tpu_torch on one CUDA card, phase by phase, and check it.

    python3 chip_smoke.py

1. Device: the card's name and power limit; build the three kernels (one
   nvcc per source, started together) and print the build time.
2. Kernel A (csrc/gf8_apply.cu) against its plain version on the card, at
   the path's shape (6 stripes of 12 x 873,814 bytes, encode rows and the
   decode rows of 4 lost data shards), in place on the degraded GET's
   strided rebuild views, at r = 1, 5 and 8 (two passes), at k + r = 256
   and at ragged shapes; exact.  Timed at the path shape beside its plan.
3. Kernel B (csrc/hh256.cu) against its plain version on the card, at the
   path's shape (96 rows x 873,814 bytes) and at ragged lengths, and both
   against the published HighwayHash test vectors; exact.  Timed at 1, 16
   and 96 rows x 873,814 bytes, in ns per packet of a row's chain.
4. Kernel C (csrc/rs_fused.cu) against its plain version on the card, at
   the path's shape (6 stripes, 12 + 4, 873,814 bytes, parity hashed),
   against Kernel A then Kernel B at that shape, at ragged shapes in both
   hash_parity modes (one with two hashing warps), and in place inside a
   frame tensor; exact.  Timed
   with and without the hash (n_real=0).
   Kernels B and C report their bound as the larger of the byte bound and
   the chain bound (one row's packet updates in series), which is the
   chain.
5. The path: a 16-drive erasure set (12 data + 4 parity, 10 MiB blocks)
   under a temporary directory.  PUT seeded objects (0 B to 256 MiB; the
   512 KiB one is packed into the drives' segment files), GET each whole
   and as a range, wipe the drives holding four data shards of the
   256 MiB object, GET it degraded, heal it, and check the healed part
   files byte for byte; then wipe the packed object from four drives,
   heal it into their segments, check each new extent against the one
   the drive held before, and GET it through the healed drives.  Then a
   burst: 8 threads each PUT 32 objects of 512 KiB (packed, group
   commits) and every body reads back; objects/s, GiB/s, group commits
   and fsyncs per object.  Launch counts are reset before the path and
   read after each of PUT, GET, heal, packed heal and burst: Kernels A
   and B must have run in each, and no plain version anywhere in the
   path.  Last, one 60 MiB batch's stages timed alone: MD5, encode +
   frame on the card, the copy into a pinned pooled buffer, and the
   256 MiB PUT's pipeline wall time per batch.
6. The mesh path: the same set built on a one-device mesh (the mesh data
   plane), driven the same way with the same bodies (without the burst).
   Its shards (part files, packed extents, inline data) must equal the
   first set's drive by drive; its PUT must launch Kernel C once per
   full-block batch and once per short last block, and Kernels A and B
   not at all; its degraded GET and heals launch Kernels A and B; no
   plain version runs.
7. The S3 front: ``build_server`` (what ``python -m minio_tpu_torch
   server`` runs) on 16 temporary drives on the card at 127.0.0.1:0, the
   same 12 + 4 set with 10 MiB blocks, driven over HTTP with the port's
   ``S3Client``: make a bucket, PUT the six bodies (the 256 MiB one
   aws-chunked with Content-MD5, so it takes the streaming route; the
   others header-signed with their SHA-256), each ETag against the body's
   MD5, GET each whole and one range, HEAD one, ListObjectsV2 with a
   delimiter, wipe the drives of four data shards of the 256 MiB object
   and GET it degraded byte for byte, DELETE it, then a burst of 8
   client threads x 32 PUTs of 512 KiB, all read back.  Launch counts are
   reset before the phase and read after PUT, GET, degraded GET and the
   burst: Kernels A and B in each but the healthy GETs, which verify
   (Kernel B) and rebuild nothing; no plain version.  One line sets the HTTP
   figures beside phase 5's in-process ones from the same run.
8. Multipart uploads and versioning over HTTP, on a fresh set built by
   ``build_server`` (the same 12 + 4 set, 10 MiB blocks, on the card): a
   512 MiB seeded object as 32 parts of 16 MiB (minio-go's part size)
   from 4 client threads (its worker count), aws-chunked with
   Content-MD5; ListParts, then CompleteMultipartUpload, whose ETag must
   be md5(part MD5s)-32 as the client computes it; a whole GET (MD5) and
   a range across a part and a block boundary; wipe the drives of four
   data shards and GET degraded; heal in the layer, check the healed part
   files byte for byte and GET through the healed drives; a 3-part upload
   aborted, no staging dir left on any drive.  Then a versioned bucket:
   an inline, a part-file and a multipart version of one key and a
   delete marker; each version by id, 405 with ``x-amz-delete-marker``
   on the latest, ListObjectVersions in order, the middle version
   deleted, one drive wiped and ``heal_object(version_id=<oldest>)``.
   Last, in-process on the one-device mesh set, a 3 x 5 MiB + 1 MiB
   upload, whose parts launch Kernel C.  Launches are read per step:
   Kernels A and B in the multipart PUT, degraded GET and heal (B alone
   in the healthy GET), C in the mesh parts; no plain version.
9. The sets path: ``build_server`` on 32 temporary drives, which it
   lays out as MinIO does, 2 sets x 16 (12 + 4 each, 10 MiB blocks, on
   the card), every drive holding format.json (one deployment id, a
   2 x 16 grid) and behind a health proxy.  Over HTTP: ``/minio/health/
   cluster``; 64 objects of 16 MiB from 8 client threads, 12 more to set 0
   alone from 4 threads, then 12 to each set at once from 4 threads each
   (deleted again), the 256 MiB body aws-chunked, a 3-part upload and the
   8 x 32 burst of 512 KiB (packed); every object's xl.meta on the drives
   of the set its name hashes to, each set a quarter of the 16 MiB objects
   at least; every object read back from 8 threads and ListObjectsV2 in
   pages of 25.  Then in each set a drive holding a data shard of the
   set's first 16 MiB object is removed, and a degraded GET of that object
   marks it offline (two launches of Kernel A each, the full and the short
   stripe), four more of set 0 taken away (11 of 16 online:
   503, and 412 under maintenance) and back (200); the two removed drives
   return empty, are formatted with their own identity by
   ``DriveMonitor.poll_once`` and their sets healed: every shard equal to
   its digest from before, each sweep on its own set, no other drive
   written.  Last, a drive of another deployment in place of one of set
   1 stays offline and unwritten.  Launches per step: A and B in PUT,
   burst, degraded GET and heal, B in the GET; no plain version.  It
   reads set 0's D2H wait per batch alone and with set 1 as busy beside
   it (the same threads and PUTs per set; one CUDA stream for every set),
   the peak thread count, and the pooled buffers checked out after the
   phase (0).
10. The control plane, on phase 9's server before it stops: set
   ``pipeline depth`` to 0 and back to 2 with the admin client, one
   16 MiB PUT under each (no writer-plane op at 0, the writer plane at
   2); two 16 MiB versions of a key in a versioned bucket (the key
   chosen to land in the set of the foreign drive, which holds one of its
   data shards), a drive holding another data shard of the key emptied
   of it, ``POST heal/<bucket>`` through the admin client: both
   versions' part files back on that drive byte for byte, Kernels A and
   B launched; both versions read back, each GET rebuilding the foreign
   drive's shard through Kernel A; the heal sweep, then
   ``heal-status`` equal to its stats and ``storageinfo`` (31 drives ok,
   the foreign one offline).  The scrape of ``/minio-tpu/metrics``
   against the one before the phase: ``mt_s3_requests_api_total`` per
   API equal to the requests the phase made, ``mt_tpu_ops_total`` per op
   (4 encodes, the matmuls of the heal and of the GETs, each read from a
   scrape taken between the two) reconciled with Kernel A's launches
   (two per 16 MiB encode, one per matmul) and each op's
   ``mt_tpu_kernel_seconds`` count equal to its op total, the heal
   counters equal to the sweep's stats, the overlap efficiency and every
   drive's writer stats present; the scrape's latency over 32 drives.
   Last, ``service?action=stop`` stops the server.
11. Identities and the request plane, on a fresh ``build_server`` of 16
   drives (the 12 + 4 set, 10 MiB blocks): root adds a policy over
   ``alpha`` and a user with it, whose 16 MiB PUT launches Kernels A and
   B twice each (one ``encode`` op in the scrape) and whose GET is
   byte-exact; the user's 16 MiB PUT to ``beta`` answers 403 with no
   launch, no codec op and nothing on the drives; an STS session bounded
   to GetObject reads and may not write; a service account writes; a
   SigV2 header-signed and a presigned GET, a 1 MiB POST-policy upload,
   and a bucket policy that lets anonymous callers GET ``alpha/pub/*``
   but not PUT.  Then ``api mem_limit`` below a 16 MiB PUT's framed
   bytes sheds it (503 SlowDown, Retry-After, ``mt_mem_shed_total`` + 1,
   no object); ``requests_max`` 1 with a stalled body in flight sheds
   further PUTs while ``/minio/health/live`` and the scrape answer; a
   body stalled after 1 MiB under ``body_deadline`` 1s answers 408
   within 3 s with no pooled buffer out; every drive's ``iam.json`` and
   ``config.json`` are sealed; ``stop()`` drains a GET in flight; a new
   ``build_server`` on the drives admits the user and the service
   account and keeps the ``api`` knobs.  No plain version runs.
12. Listing and usage, on phase 9's server after phase 10 and before its
   stop: ListObjectsV2 of ``sets`` in pages of 25 cold (every set's
   listing snapshot dropped first: one walk per set), warm within the
   15 s TTL (every page a hit of every set's snapshot) and after one PUT
   (a walk per set: the layer invalidated one, the tracker's mark made
   the other stale), each equal to the keys phases 9 and 10 left; the
   first page of a cold walk under cProfile in this process, its top 10
   functions printed; one crawler cycle, whose ``datausageinfo`` counts
   and bytes for ``sets`` equal those of the objects phases 9 and 10
   wrote, as does ``mt_bucket_usage_total_bytes`` in the scrape; in a
   new bucket 8 objects under ``exp/`` and 2 beside them, a lifecycle
   ``Expiration`` dated in the past on ``exp/``, one cycle: the 8 gone
   from the listing and the drives, the 2 kept; a hard quota of 32 MiB:
   two 16 MiB PUTs reach it, the third answers 403
   ``XMinioAdminBucketQuotaExceeded`` with no launch and no codec op.
   The listings, the cycles and the expiry launch nothing; the PUTs
   launch Kernels A and B; no plain version.  ``MT_CRAWL_INTERVAL_S`` is
   a day for the whole script, so no cycle lands inside an earlier
   phase's readings.
13. Server pools, on their own server: ``ErasureServerPools`` over one
   16-drive pool (12 + 4, 10 MiB blocks, on the card) behind an
   S3Server with the tracker, the crawler and a rebalancer (0.25 s,
   threshold 0.05) attached, as ``minio_tpu/soak/chaos.py`` builds a
   pooled node.  Over HTTP: 16 x 16 MiB, 16 x 512 KiB (packed) and a
   3-part upload of 3 x 16 MiB into ``pools``, two versions of a key and
   a delete marker over another in versioned ``poolsv``; ``pool-add``
   twice (16 drives each; ``pool-status`` three active); 32 x 16 MiB more,
   each new pool receiving some; two versions and a marked key placed on
   pool 1, and an upload pinned to pool 1; a shard of one object per pool
   removed; every 16 MiB object read back (Kernel A rebuilds the lost
   shards).  ``pool-decommission`` pool 1, then its upload completed and
   its last key overwritten and read back at once (the new body); pool 1
   retired within 120 s, ``rebalance-status``'s moves equal to the
   scrape's ``mt_rebalance_moved_*_total``, no object file left on its
   drives, every key, version and marker read back with its ETag,
   version id and Last-Modified.  One crawler cycle: ``mt_pool_usage_bytes``
   of the two pools left sums to the bytes written, ``pool-status`` carries
   the usage.  Stopped, rebuilt from pool 0's drives alone and its
   manifest (pools 0 and 2 back), every key read again; no
   ``mt-rebalance`` thread outlives a stop.  Kernels A and B launch in
   the one-pool PUT, the three-pool PUT, the GET and the drain; no plain
   version.  PUT GiB/s on one pool and on three (each PUT probes every
   pool), GET GiB/s, the drain's seconds, objects and GiB/s, the
   restart's seconds.
14. Copy, tagging and object lock, on their own ``build_server`` of
   phase 9's deployment (32 drives, 2 sets x 16, 12 + 4, 10 MiB blocks,
   on the card), over HTTP: 8 x 16 MiB copied into a second bucket from
   4 client threads (within a set and across the two), the 256 MiB body
   copied once; a REPLACE copy of metadata and tags and a copy of a
   version by id; a copy of a source whose four data-shard drives lost
   it (Kernel A rebuilds them: more launches than a healthy copy); an
   upload of three UploadPartCopy ranges of the 256 MiB body (100 + 100
   + 56 MiB), completed and read back byte for byte; PUT, GET and DELETE
   ``?tagging`` on 16 objects; a lock-enabled bucket with a 1-day
   GOVERNANCE default and 4 x 16 MiB: a version DELETE refused
   ``ObjectLocked`` without the bypass and allowed with it, a COMPLIANCE
   version and one under legal hold refused even with it.  Every body
   checked against its source.  Kernels A and B launch in the copies,
   the degraded copy and the part copies; the tag calls and the
   refusals launch nothing; no plain version.  Copy GiB/s, the 256 MiB
   copy's and the part copies' seconds, the degraded copy's seconds,
   the tag call's and each refusal's milliseconds.
15. Storage classes, SSE and compression, on phase 14's server before it
   stops, over HTTP: an SSE-S3 PUT of 16 MiB, its GET and a ranged GET
   (decrypting only the covering DARE packages); a compressed PUT of
   4 MiB of text and its GET (the pure-Python snappy engine on the
   host); a REDUCED_REDUNDANCY PUT of 16 MiB (14 data + 2 parity shards
   on a 16-drive set, a second geometry through the same kernels), its
   GET with two of its data-shard drives wiped (Kernel A rebuilds them
   with that geometry's decode rows); a REDUCED_REDUNDANCY upload of
   2 x 5 MiB parts, completed and read.  Every body checked.  Kernels A
   and B launch in each write step and Kernel A in the degraded read; no
   plain version.  Each step's seconds and GiB/s.
16. Transitions to a tier and restore, then S3 Select, on phase 15's
   server before it stops, over HTTP: a directory tier and an S3 tier
   (a second bucket of the same server) added through the admin
   ``tier`` route; two 16 MiB objects (one SSE-S3) under a rule for the
   first and one under a rule for the second, Transition dates in the
   past, moved by one crawler cycle in process; each stub answers GET
   and Select InvalidObjectState and HEAD its size, ETag and storage
   class, its
   drives hold no part file and its tier the stored bytes (ciphertext
   for the SSE object); ``POST ?restore`` answers 202, the GET its body,
   a second restore 200; a restored stub copied; the DELETEs free the
   tier copies.  Then a seeded CSV of 15.3 MB, the same rows as JSON
   lines and as a gzip CSV, each queried with a WHERE and an aggregate
   (``?select&select-type=2``) and checked against a plain evaluation
   here, the WHERE again over an SSE-S3 copy and over the CSV with the
   drives of four data shards wiped.  Kernel B launches in the
   transitions, A and B in each restore, B in each Select and A too in
   the degraded one; no plain version.  Each transition's, restore's and
   Select's seconds, each Select's MB/s of scanned bytes, and the CSV's
   layer read alone, three times.
17. The other bucket configs and event notification, on phase 16's
   server before it stops, over HTTP: ``?replication`` PUT, GET and
   DELETE on a versioned bucket (InvalidRequest on an unversioned one),
   ``?acl`` on a bucket and an object (private only), ``?cors`` and the
   dummy subresources.  A 16 MiB PUT, its GET and a GET with four
   data-shard drives wiped, timed and counted without a notification
   config; then a webhook sink in this process on a free local port,
   ``notify_webhook`` pointed at it through SetConfigKV, a notification
   config (an unknown ARN refused first) for the created, accessed,
   removed and restore events under ``ev/``, and a ListenNotification
   stream on the bucket, read line by line.  Under ``ev/``: a 16 MiB
   PUT, its GET, a degraded GET, a 2 x 8 MiB upload, a copy, a tag, a
   transition to phase 16's S3 tier and a restore, a DELETE (a marker),
   and one key outside ``ev/``.  The sink and the stream hold the
   expected event names, keys, sizes, ETags and version ids, in request
   order per key (the outside key on the stream only).  The sink
   stopped, two PUTs: ``targets`` shows the target offline with both
   records in its ``queue_dir``; the sink back, ``targets/replay``
   delivers both and empties the store; the scrape carries
   ``mt_target_*``.  Each PUT, GET and degraded GET launches what it
   launched without notification; the delivery, the storing and the
   replay launch nothing; no plain version.  The PUT's seconds with and
   without notification, the median and largest delay from a response
   to its record at the sink and at the listener, the replay's seconds.
   Last, ``notify_webhook`` is turned off before its ``queue_dir`` goes.
18. Bucket replication, on phase 17's server before it stops: a second
   ``build_server`` (16 drives, one 12 + 4 set, 10 MiB blocks, on the
   card) in this process is the destination.  ``set-remote-target`` and
   ``list-remote-targets``; a replication rule on ``in/`` naming an
   unknown ARN refused, then one naming the target.  A 16 MiB PUT
   outside the rule, its GET, and a 16 MiB PUT straight to the
   destination, each alone; then under ``in/``, each step drained: a
   16 MiB PUT with an ``x-amz-meta-*`` header and a content type, a
   2 x 8 MiB upload, a copy, two PUTs of one key back to back, a DELETE
   (a marker, DeleteMarkerReplication on) and a PUT outside the rule.
   Every replica's GET equals the source's GET with its metadata, both
   versions of the twice-written key arrive with the newer latest,
   every source version is stamped COMPLETED, ``replication-stats``
   holds the counts.  An SSE-S3 16 MiB object arrives as its GET gives
   it.  ``set-bandwidth-limit`` at 8 MiB/s: a 16 MiB task sleeps at
   least 0.9 s and ``bandwidth`` reports the bytes moved.  The
   destination stopped, a PUT's task fails and stamps FAILED.  The
   scrape carries ``mt_replication_*`` and ``background-status`` its
   ``replication`` field.  Each replicated PUT launches what the PUT,
   the source GET and the destination PUT launch alone, the throttled one
   too; the registry, the replicated DELETE and a stamp launch nothing;
   no plain version.  The seconds from each 16 MiB PUT's response to its
   COMPLETED stamp (median and largest) and the throttled task's.
19. The broker targets, on phase 18's server before it stops: a 16 MiB
   PUT, its GET and a GET with four data-shard drives wiped, timed and
   counted with no broker target; then the nine frame-parsing stubs of
   ``tests/broker_stubs.py`` in this process on free local ports (AMQP,
   Kafka, MQTT, NATS, NSQ, Redis, MySQL, PostgreSQL, Elasticsearch; the
   MySQL one checks the scramble with the port's function), the nine
   ``notify_<kind>`` subsystems set through SetConfigKV (namespace format
   for Redis, MySQL and PostgreSQL, access for Elasticsearch, MQTT at QoS
   1, a ``queue_dir`` each), and a notification config on ``br/`` naming
   the nine ARNs (an unknown ARN refused first).  Under ``br/``: a 16 MiB
   PUT, its GET, a degraded GET, a second PUT of the key and a DELETE,
   each awaited at every stub, then a key outside ``br/``.  The
   message-per-event stubs and the access index hold the expected event
   names, keys, sizes and ETags in request order, MQTT at QoS 1; the
   namespace rows are set by the PUT and removed by the DELETE; nothing
   arrives for the outside key.  The Kafka stub down, two PUTs:
   ``targets`` shows Kafka offline with both records in its
   ``queue_dir`` while the other eight deliver them; the stub back on its
   port, ``targets/replay`` delivers both in order and empties the store;
   the scrape carries ``mt_target_*`` of the nine, each having sent every
   record.  Each PUT, GET and degraded GET launches what it launched with
   no target; the deliveries, the storing and the replay launch nothing;
   no plain version.  The delay from each response to its record at each
   stub (per step; median and largest per kind over the PUTs and the
   DELETE, since a GET's record comes before its body ends), each
   target's mean delivery seconds, a 16 MiB PUT and GET with the nine
   targets and without in alternating pairs, the replay's seconds.
20. The external identities, on a fresh ``build_server`` of 16 drives
   (12 + 4, 10 MiB blocks, on the card) built with ``identity_ldap``,
   ``identity_openid`` (an HS256 secret and an inline RS256 JWKS whose key
   the script makes itself: two Miller-Rabin primes from ``secrets``) and
   ``etcd`` set in the environment, the environment cleared after the
   build.  In this process on free local ports: an LDAP stub of the
   script's own (the directory of ``tests/ldap_stub.py``, decoded with the
   port's BER codec), ``tests/etcd_stub.py`` and an OPA stub that allows
   only ``s3:GetObject``.  etcd: a policy and a user added through the
   admin API land under ``config/iam/`` in the stub, and no drive gains
   ``config/iam.json``.  LDAP: a group DN mapped to ``readwrite`` through
   ``set-user-policy``; unsigned AssumeRoleWithLDAPIdentity calls; with the
   session, a 16 MiB PUT, its GET and a GET with four data-shard drives
   wiped launch exactly the Kernel A and B counts that the same three
   requests launch with the root credential; a wrong password is refused
   (InvalidParameterValue, as the reference answers) and launches nothing.
   OpenID: an HS256 and an RS256 token each get a session whose GET
   returns the body; an expired token, a wrong ``aud`` and a flipped
   signature byte are refused.  OPA, armed through ``SetConfigKV
   policy_opa url``: the user's GET allowed, its 16 MiB PUT denied
   without a launch, root never sent to the webhook, a 16 MiB GET with
   the webhook and without in alternating pairs, the GET denied with the
   stub down within ``timeout`` x ``retry_attempts``,
   ``mt_policy_webhook_total`` equal per verdict to the decisions made,
   and local policy back with an empty ``url``.  Then a second server on
   the same drives and etcd serves the user's GET.  Printed beside the
   card: the median LDAP and web-identity STS call, the GET pairs, an
   etcd-persisted IAM mutation's seconds and the phase's.
21. Distributed nodes: four ``python -m minio_tpu_torch node --device
   cuda`` processes on free loopback ports, sharing the card, each with
   4 temporary drives: one set of 16 (12 + 4, 10 MiB blocks) over every
   node's drives, the shards crossing the internode RPC.  Four 16 MiB
   objects and one of 256 MiB PUT through node 1 and read through node 3
   byte for byte; the first 16 MiB PUT, its GET and (later) its degraded
   GET launch, by the serving node's ``mt_tpu_kernel_launches_total``,
   what the same requests launch on a ``build_server`` of 16 drives in
   this process.  Two PUTs of one key at once through nodes 1 and 2 leave
   one whole version, the same through every node.  A user and a bucket
   policy added through node 1 authorise a GET through node 2 at once.
   Node 4 killed (SIGKILL): every body read through node 2, the degraded
   16 MiB GET launching Kernel A.  Node 4 started again on wiped drives:
   its own start formats them and heals its set onto them, every
   ``part.1`` it held back byte for byte.  Printed beside the card: the
   256 MiB PUT and GET through the cluster (GiB/s, median of three), the
   degraded GET's, the heal's, a node boot's and the phase's seconds,
   and an RPC ping's median milliseconds.  Every node process is stopped
   and waited for, also when a check fails.
22. Internode TLS, the chaos drills and bucket federation.  A CA, an S3
   leaf and an internode leaf minted with the port's ``secure/pki.py``
   (whether the system ``openssl`` is there is printed) and laid out as
   a ``certs_dir``.  Phase 21's four node processes again, with
   ``MT_TLS_ENABLE=on``: every node dials its peers at ``https://`` and
   serves S3 over ``https``; a 16 MiB and a 256 MiB object PUT through
   node 1 and read through node 3 byte for byte, each request launching
   by the serving node's scrape what it launched in phase 21; a client
   without the internode certificate refused by node 2's RPC port and
   counted in its ``mt_tls_handshake_failed_total{plane="internode"}``;
   every scrape carries ``mt_tls_handshake_total`` and
   ``mt_tls_cert_expiry_seconds``.  Then, in this process, the same 4 x
   4 layout under ``tls`` with a ``FaultyProxy`` in front of each RPC
   port (the nodes boot, the proxies are advertised, then the layers
   assemble), the ``rpc`` breaker at 2 failures, a 200 ms cooldown and
   one attempt: node 4's proxy resets every new connection from the
   middle of a streamed 256 MiB PUT, which commits on the other 12
   drives; node 4's breakers open and fail fast; back to pass-through,
   the heal brings its part files back (Kernel A), a deep check
   verifies all 16 and a GET through node 2 returns the body; black-holed,
   an RPC call with a 1 s timeout raises within 5 s.  Last, two
   ``build_server`` fronts of 4 drives on one ``federation.dns_file``: a
   bucket made on A is refused on B (BucketAlreadyExists), a GET through
   B answers 307 to A and the redirect serves the body, and DELETE
   bucket frees the name.  Printed beside the card: the 256 MiB PUT and
   GET through the TLS cluster (median of two) beside phase 21's, the
   mTLS RPC ping's median beside phase 21's, a handshake's median, the
   chaos PUT's, the heal's and the black-holed call's seconds, node boot
   and the phase.
23. One JSON line of readings, one describing each kernel, the card line,
   and the result line.

Any mismatch raises, and the script exits nonzero without the result
line; it also exits nonzero when torch sees no card.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
# The HighwayHash update's loop-carried dependency chain, from the SASS of
# csrc/rs_fused.cu: v1 += mul0 + packet (IADD3, IADD3.X), the zipper of v1
# into v0 (two dependent PRMTs, then IADD3, IADD3.X), the zipper of v0
# into v1 (two PRMTs, IADD3, IADD3.X): 10 dependent integer instructions
# per packet, each at least 4 cycles on Hopper.
CHAIN_CYCLES_PER_UPDATE = 10 * 4
QUEUE_AHEAD_CYCLES = 40_000_000   # ~20 ms of sleep at the SM clock
K, M = 12, 4
BLOCK = 10 * 1024 * 1024
N_PATH = -(-BLOCK // K)            # 873,814: shard width at 10 MiB blocks
B_PATH = 6                         # stripes per 64 MiB stream batch


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream.  A
    sleep kernel holds the stream while the host queues the calls, so a
    kernel shorter than its Python wrapper is timed back to back, not at
    the host's pace."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def rand_bytes(shape, gen) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                         generator=gen)


def bounds(nbytes: int, clock_mhz: float) -> dict:
    """The bound fields of a hashing kernel: bytes moved over the card's
    memory rate, the chain bound, and the larger of the two."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = chain_bound_ms(clock_mhz)
    return {"bound_ms": max(byte_ms, chain_ms),
            "bound_by": "chain" if chain_ms >= byte_ms else "bytes",
            "byte_bound_ms": byte_ms, "chain_bound_ms": chain_ms}


def chain_bound_ms(clock_mhz: float) -> float:
    """The least time one row's HighwayHash-256 at the path's shard width
    can take: its packet, remainder and 10 permute updates in series, each
    the update's dependency chain long, at the card's maximum SM clock."""
    updates = N_PATH // 32 + (1 if N_PATH % 32 else 0) + 10
    ms = updates * CHAIN_CYCLES_PER_UPDATE / (clock_mhz * 1e3)
    print(f"chain bound: {updates} updates per row x "
          f"{CHAIN_CYCLES_PER_UPDATE} cycles at {clock_mhz:.0f} MHz = "
          f"{ms:.4f} ms")
    return ms


def check_apply(rows, x, what: str, out=None) -> None:
    """Kernel A against its plain version on the same inputs, exact; with
    ``out``, in place."""
    from minio_tpu_torch.ops import rs_kernels
    got = rs_kernels.apply_matrix(rows, x, out=out)
    want = rs_kernels.gf_apply_ref(rows, x.contiguous())
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"kernel A {what}")


def phase_kernel_a(gen) -> dict:
    from minio_tpu_torch.ops import gf8, rs_kernels
    enc = gf8.rs_matrix(K, K + M)[K:]
    present = list(range(M, K + M))                  # data 0..3 lost
    dec = rs_kernels.decode_rows(gf8.rs_matrix(K, K + M), K, present,
                                 list(range(M)))
    data = rand_bytes((B_PATH, K, N_PATH), gen)
    for name, rows in (("encode", enc), ("decode", dec)):
        check_apply(rows, data, f"{name} at the path shape")
    # the degraded GET's rebuild: survivors (k, L) and the rebuilt rows
    # (4, L) as (stripes, rows, shard) views, batch stride one shard,
    # written in place inside a larger tensor whose margins must not move
    span = B_PATH * N_PATH
    surv = rand_bytes((K, span), gen)
    buf = rand_bytes((M, span + 32), gen)
    before = buf.clone()

    def view(t):
        return t.unflatten(1, (B_PATH, N_PATH)).transpose(0, 1)
    check_apply(dec, view(surv), "rebuild view at the degraded-GET shape",
                out=view(buf[:, 19:19 + span]))
    check(torch.equal(buf[:, :19], before[:, :19])
          and torch.equal(buf[:, 19 + span:], before[:, 19 + span:]),
          "kernel A wrote outside the rebuild view")
    shapes = 3
    for r in (1, 5, 8):                              # one to two passes
        check_apply(gf8.rs_matrix(K, K + r)[K:],
                    rand_bytes((3, K, 100_003), gen), f"r={r}")
        shapes += 1
    for k in (4, 128, 252):                          # k + r = 256
        check_apply(gf8.rs_matrix(k, 256)[k:], rand_bytes((2, k, 1000), gen),
                    f"k={k} r={256 - k}")
        shapes += 1
    for k, m in ((K, M), (4, 2)):
        mat = gf8.rs_matrix(k, k + m)[k:]
        for n in (1, 15, 16, 17, 31, 300, 4097):
            for b in (1, 64):
                check_apply(mat, rand_bytes((b, k, n), gen),
                            f"B={b} k={k} m={m} n={n}")
                shapes += 1
    ms = cuda_ms(lambda: rs_kernels.apply_matrix(enc, data), 50)
    plain_ms = cuda_ms(lambda: rs_kernels.gf_apply_ref(enc, data), 3)
    nbytes = (K + M) * N_PATH * B_PATH
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    plan = rs_kernels.plan(B_PATH, K, M, N_PATH)
    # what limits it: eight output rows are two passes of the product over
    # the same staged input (twice the product, 1.25 times the bytes), and
    # a device copy of the input shows the memory rate the card gives
    enc8 = gf8.rs_matrix(K, K + 8)[K:]
    ms_r8 = cuda_ms(lambda: rs_kernels.apply_matrix(enc8, data), 50)
    copy = torch.empty_like(data)
    copy_ms = cuda_ms(lambda: copy.copy_(data), 50)
    print(f"kernel A: exact at {shapes} shapes (the path's encode and "
          f"decode, the rebuild view in place, r = 1, 5, 8, k + r = 256, "
          f"ragged); B={B_PATH} k={K} r={M} n={N_PATH}: plan {plan}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes} bytes), {bound_ms / ms:.1%} of the bound; r=8 "
          f"{ms_r8:.4f} ms; a device copy of the input {copy_ms:.4f} ms "
          f"({2 * data.numel() / copy_ms / 1e9:.3f} TB/s)")
    return {"name": "gf8_apply", "route": "cuda",
            "source": "minio_tpu_torch/csrc/gf8_apply.cu",
            "replaces": "minio_tpu/ops/rs_pallas.py:95",
            "exact": True, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "share_of_bound": bound_ms / ms, "plan": plan,
            "ms_r8": ms_r8, "copy_ms": copy_ms,
            "shape": [B_PATH, K, M, N_PATH]}


HH_TEST_KEY = bytes(range(32))          # 0x0706050403020100 ... LE words
HH64_VECTORS = {0: 0x907A56DE22C26E53, 1: 0x7EAB43AAC7CDDD78,
                2: 0xB8D0569AB0B53D62}
HH256_VECTOR_0 = (0xDD44482AC2C874F5, 0xD946017313C7351F,
                  0xB3AEBECCB98714FF, 0x41DA233145751DF4)


def phase_kernel_b(gen, clock_mhz: float, card: str) -> dict:
    from minio_tpu_torch.ops import hh
    for n, want in HH64_VECTORS.items():
        row = torch.arange(n, dtype=torch.uint8, device="cuda").reshape(1, n)
        for fn in (hh.hh64_batch, lambda b, k: hh.hh256_batch_ref(b, k, 8)):
            got = fn(row, HH_TEST_KEY).cpu().numpy().tobytes()
            check(int.from_bytes(got, "little") == want,
                  f"HighwayHash64 vector n={n}")
    empty = torch.zeros((1, 0), dtype=torch.uint8, device="cuda")
    for fn in (hh.hh256_batch, hh.hh256_batch_ref):
        got = fn(empty, HH_TEST_KEY).cpu().numpy().tobytes()
        check(tuple(np.frombuffer(got, "<u8")) == HH256_VECTOR_0,
              "HighwayHash256 vector n=0")
    lengths = (0, 1, 31, 32, 33, 2047, 2048, 2049, 64 * 32 + 5)
    for n in lengths:
        x = rand_bytes((300, n), gen)
        check(torch.equal(hh.hh256_batch(x), hh.hh256_batch_ref(x)),
              f"kernel B at 300 rows x {n}")
    rows = B_PATH * (K + M)                             # 96 rows per batch
    x = rand_bytes((rows, N_PATH), gen)
    got = hh.hh256_batch(x)
    plain = []                     # one run: the chain takes ~30 s here
    plain_ms = cuda_ms(lambda: plain.append(hh.hh256_batch_ref(x)), 1)
    check(torch.equal(got, plain[0]), f"kernel B at {rows} rows x {N_PATH}")
    cuda_ms(lambda: hh.hh256_batch(x), 1)                 # warm
    by_rows = {r: cuda_ms(lambda: hh.hh256_batch(x[:r]), 5)
               for r in (1, K + M, rows)}
    ms = by_rows[rows]
    packets = N_PATH // 32
    b = bounds(rows * N_PATH + rows * 32, clock_mhz)
    times = ", ".join(f"{r} rows {t:.4f} ms ({t * 1e6 / packets:.1f} ns per "
                      "packet)" for r, t in by_rows.items())
    print(f"kernel B: published vectors and {len(lengths)} ragged lengths x "
          f"300 rows exact, and {rows} rows x {N_PATH}; plan "
          f"{hh.plan(rows, N_PATH)}; x {N_PATH}: {times}; plain "
          f"{plain_ms:.1f} ms (one run, {rows} rows); byte bound "
          f"{b['byte_bound_ms']:.4f} ms, chain bound "
          f"{b['chain_bound_ms']:.4f} ms ({packets} packets per row); {card}")
    return {"name": "hh256", "route": "cuda",
            "source": "minio_tpu_torch/csrc/hh256.cu",
            "replaces": "minio_tpu/ops/hh_pallas.py:163",
            "exact": True, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "shape": [rows, N_PATH],
            "chain_packets": packets,
            "ms_by_rows": {str(r): t for r, t in by_rows.items()},
            "ns_per_packet_by_rows": {str(r): t * 1e6 / packets
                                      for r, t in by_rows.items()}}


def phase_encode_layout(gen) -> None:
    """The path's strided encode layout against the same encode on the
    CPU (plain version), for a body one byte past a block."""
    from minio_tpu_torch.ops.codec import Erasure
    body = rand_bytes((BLOCK + 1,), gen)
    got = Erasure(K, M, BLOCK, device="cuda").encode_object(body)
    want = Erasure(K, M, BLOCK, device="cpu").encode_object(body.cpu())
    check(torch.equal(got.cpu(), want), "encode_object cuda vs cpu")


def phase_kernel_c(gen, clock_mhz: float, card: str) -> dict:
    from minio_tpu_torch.ops import gf8, hh, rs_fused, rs_kernels
    ragged = 0
    # (20, 4): more than 16 hashed rows, a second hashing warp
    for k, m in ((K, M), (4, 2), (5, 1), (3, 2), (20, 4)):
        mat = gf8.rs_matrix(k, k + m)[k:]
        for n in (1, 31, 32, 33, 2047, 2048, 2049, 4097):
            for b in (1, 7):
                x = rand_bytes((b, k, n), gen)
                for hp in (True, False):
                    got = rs_fused.encode_hash_device(mat, x, hash_parity=hp)
                    want = rs_fused.encode_hash_ref(mat, x, hash_parity=hp)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"kernel C at B={b} k={k} m={m} n={n} "
                          f"hash_parity={hp}")
                    ragged += 1
    enc = gf8.rs_matrix(K, K + M)[K:]
    # in place inside a frame tensor: 3 frames of 32-byte digest slots and
    # 5,001-byte payloads on 16 rows; only the parity payloads may change
    ss, nf = 5001, 3
    frames = rand_bytes((K + M, nf * (32 + ss)), gen)
    before = frames.clone()
    view = frames.unflatten(1, (nf, 32 + ss)).transpose(0, 1)
    _, dig = rs_fused.encode_hash_device(enc, view[:, :K, 32:],
                                         out_parity=view[:, K:, 32:])
    par, want = rs_fused.encode_hash_ref(enc, view[:, :K, 32:].contiguous())
    check(torch.equal(view[:, K:, 32:], par) and torch.equal(dig, want),
          "kernel C strided into a frame tensor")
    view[:, K:, 32:] = before.unflatten(1, (nf, 32 + ss)).transpose(
        0, 1)[:, K:, 32:]
    check(torch.equal(frames, before),
          "kernel C wrote outside the parity payloads")

    data = rand_bytes((B_PATH, K, N_PATH), gen)
    got = rs_fused.encode_hash_device(enc, data)
    plain = []                     # one run: the plain chain takes ~30 s
    plain_ms = cuda_ms(lambda: plain.append(rs_fused.encode_hash_ref(enc,
                                                                     data)), 1)
    check(all(torch.equal(g, w) for g, w in zip(got, plain[0])),
          "kernel C at the path shape")
    par_a = rs_kernels.apply_matrix(enc, data)
    dig_b = hh.hh256_batch(torch.cat([data, par_a], dim=1))
    check(torch.equal(got[0], par_a) and torch.equal(got[1], dig_b),
          "kernel C against Kernel A then Kernel B at the path shape")
    ms = cuda_ms(lambda: rs_fused.encode_hash_device(enc, data), 10)
    # the same launch with an empty hashed width: loads, product and
    # stores only, the hashing warp idle
    nohash_ms = cuda_ms(
        lambda: rs_fused.encode_hash_device(enc, data, n_real=0), 10)
    rows = K + M
    nbytes = B_PATH * rows * N_PATH + B_PATH * rows * 32
    b = bounds(nbytes, clock_mhz)
    packets = N_PATH // 32
    print(f"kernel C: exact against its plain version at {ragged} ragged "
          f"shapes, in place in a frame tensor, and at the path shape, and "
          f"against Kernel A then Kernel B there; plan "
          f"{rs_fused.plan(B_PATH, K, M, N_PATH)}; B={B_PATH} k={K} r={M} "
          f"n={N_PATH}: kernel {ms:.4f} ms ({ms * 1e6 / packets:.1f} ns per "
          f"packet), without the hash {nohash_ms:.4f} ms "
          f"({nohash_ms * 1e6 / packets:.1f} ns per packet), plain "
          f"{plain_ms:.1f} ms (one run), byte bound "
          f"{b['byte_bound_ms']:.4f} ms ({nbytes} bytes), chain bound "
          f"{b['chain_bound_ms']:.4f} ms; {card}")
    return {"name": "rs_fused", "route": "cuda",
            "source": "minio_tpu_torch/csrc/rs_fused.cu",
            "replaces": "minio_tpu/ops/rs_fused.py:171",
            "exact": True, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "nohash_ms": nohash_ms,
            "ns_per_packet": ms * 1e6 / packets,
            "nohash_ns_per_packet": nohash_ms * 1e6 / packets,
            "shape": [B_PATH, K, M, N_PATH], "chain_packets": packets}


KERNELS = ("gf8_apply", "hh256", "rs_fused")


def snapshot():
    from minio_tpu_torch.ops import hh, rs_fused, rs_kernels
    counts = {"gf8_apply": rs_kernels.COUNTS, "hh256": hh.COUNTS,
              "rs_fused": rs_fused.COUNTS}
    return {k: (c.launches, c.plain) for k, c in counts.items()}


def reset_counts():
    from minio_tpu_torch.ops import hh, rs_fused, rs_kernels
    for c in (rs_kernels.COUNTS, hh.COUNTS, rs_fused.COUNTS):
        c.reset()


def delta(a, b):
    return {k: (b[k][0] - a[k][0], b[k][1] - a[k][1]) for k in a}


PACKED = "512KiB"                  # in the packed band (128 KiB, 1 MiB)
BURST_THREADS, BURST_EACH, BURST_SIZE = 8, 32, 512 * 1024


def make_bodies(gen) -> dict:
    sizes = {"empty": 0, "inline": 100 * 1024, PACKED: 512 * 1024,
             "1MiB": 1 << 20, "block+1": BLOCK + 1, "256MiB": 256 << 20}
    return {name: rand_bytes((size,), gen).cpu().numpy().tobytes()
            for name, size in sizes.items()}


def shard_bytes(disk, name: str) -> bytes:
    """A drive's framed shard of the object, read through its XLStorage:
    the packed extent, the part file or the inline data."""
    fi = disk.read_version("smoke", name)
    if fi.seg is not None:
        return disk.read_segment(fi.seg["sid"], fi.seg["off"],
                                 fi.seg["len"])
    if fi.inline_data is not None:
        return fi.inline_data
    return disk.read_all("smoke", f"{name}/{fi.data_dir}/part.1")


def shard_digests(er, name: str) -> dict:
    """{drive: (layout, sha256 of its shard)}."""
    out = {}
    for d, disk in enumerate(er.disks):
        fi = disk.read_version("smoke", name)
        layout = ("packed" if fi.seg is not None else
                  "inline" if fi.inline_data is not None else "part")
        out[d] = (layout, hashlib.sha256(shard_bytes(disk, name)).digest())
    return out


def victims_of(er, name: str) -> list[int]:
    """The drives holding data shards 1..4 of the object."""
    fi, _ = er._read_quorum_fileinfo("smoke", name)
    victims = [d for d, shard in enumerate(fi.erasure.distribution)
               if shard <= M]
    check(len(victims) == M, "victims")
    return victims


def wipe(root: str, name: str, drives) -> None:
    for d in drives:
        shutil.rmtree(f"{root}/d{d}/smoke/{name}")


def packed_heal(er, root: str, body: bytes) -> float:
    """Wipe the packed object from the drives of four data shards, heal it
    into their own segments, check each new extent against the one the
    drive held, GET through the healed drives; returns the heal's
    seconds."""
    from minio_tpu_torch.ops import rs_kernels
    victims = victims_of(er, PACKED)
    saved = {d: shard_bytes(er.disks[d], PACKED) for d in victims}
    check(all(er.disks[d].read_version("smoke", PACKED).seg is not None
              for d in range(K + M)), f"{PACKED} is not packed")
    wipe(root, PACKED, victims)
    a_before = rs_kernels.COUNTS.launches
    t0 = time.perf_counter()
    res = er.heal_object("smoke", PACKED)
    torch.cuda.synchronize()
    heal_s = time.perf_counter() - t0
    check(rs_kernels.COUNTS.launches > a_before,
          "packed heal launched no Kernel A")
    check(len(res.healed_disks) == M, f"healed {res.healed_disks}")
    for d in victims:
        fi = er.disks[d].read_version("smoke", PACKED)
        check(fi.seg is not None and shard_bytes(er.disks[d], PACKED)
              == saved[d], f"healed extent on drive {d} differs")
    wipe(root, PACKED, [d for d in range(K + M) if d not in victims][:M])
    _, got = er.get_object("smoke", PACKED)
    check(got == body, f"GET {PACKED} through healed drives")
    return heal_s


def fsync_ms(root: str, count: int = 50) -> float:
    """Median milliseconds of one 4 KiB write + fsync to a file under
    ``root`` (the drives' disk): what one group-commit round waits on."""
    path = os.path.join(root, "fsync-probe")
    times = []
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        for _ in range(count):
            os.write(fd, b"x" * 4096)
            t0 = time.perf_counter()
            os.fsync(fd)
            times.append(time.perf_counter() - t0)
    finally:
        os.close(fd)
        os.remove(path)
    return float(np.median(times)) * 1e3


def new_set(root: str, mesh=None):
    """A fresh 16-drive set (12 data + 4 parity, 10 MiB blocks) on the
    card, its drives under ``root``, with the bucket ``smoke``."""
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.storage.xl_storage import XLStorage
    drives = []
    for i in range(K + M):
        os.makedirs(f"{root}/d{i}")
        drives.append(XLStorage(f"{root}/d{i}"))
    er = ErasureObjects(drives, parity=M, device="cuda", mesh=mesh)
    er.make_bucket("smoke")
    return er


def burst_bodies() -> list:
    """The burst's BURST_THREADS x BURST_EACH seeded bodies."""
    n = BURST_THREADS * BURST_EACH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    blob = rand_bytes((n * BURST_SIZE,), gen).cpu().numpy().tobytes()
    return [blob[i * BURST_SIZE:(i + 1) * BURST_SIZE] for i in range(n)]


def put_burst(er, bodies: list) -> float:
    """PUT ``bodies`` as ``burst/<i>`` from BURST_THREADS threads at once;
    returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor

    def put_many(t):
        for i in range(t, len(bodies), BURST_THREADS):
            er.put_object("smoke", f"burst/{i}", bodies[i])

    with ThreadPoolExecutor(BURST_THREADS) as pool:
        t0 = time.perf_counter()
        list(pool.map(put_many, range(BURST_THREADS)))
        return time.perf_counter() - t0


def read_back(er, bodies: list) -> None:
    for i, body in enumerate(bodies):
        _, got = er.get_object("smoke", f"burst/{i}")
        check(got == body, f"burst object {i} reads back")


def burst(er, root: str, card: str) -> dict:
    """BURST_THREADS threads each PUT BURST_EACH packed objects of
    BURST_SIZE bytes at once; every body must read back."""
    from minio_tpu_torch.storage import commit
    bodies = burst_bodies()
    n = len(bodies)
    commit.COUNTS.reset()
    wall = put_burst(er, bodies)
    c = commit.COUNTS
    out = {"objects": n, "object_bytes": BURST_SIZE, "threads":
           BURST_THREADS, "wall_s": wall, "objects_per_s": n / wall,
           "gib_per_s": n * BURST_SIZE / wall / 2**30,
           "group_commits": c.batches, "grouped": c.grouped,
           "largest_group": c.largest, "ops": c.ops,
           "fsyncs_per_object": c.fsyncs / n,
           "deferred_fsyncs_per_object": c.deferred / n,
           "ops_per_group": c.ops / max(1, c.batches),
           "fsync_4KiB_median_ms": fsync_ms(root)}
    read_back(er, bodies)
    print(f"burst on {card}: {n} objects of {BURST_SIZE} B from "
          f"{BURST_THREADS} threads in {wall:.3f} s: "
          f"{out['objects_per_s']:.1f} objects/s, {out['gib_per_s']:.4f} "
          f"GiB/s; {c.batches} group commits ({c.grouped} of more than one "
          f"op, largest {c.largest}, {out['ops_per_group']:.2f} ops each), "
          f"{out['fsyncs_per_object']:.2f} fsyncs per object (an eager "
          f"commit would issue {out['deferred_fsyncs_per_object']:.2f}); "
          f"every body read back; one 4 KiB write + fsync on the drives' "
          f"disk takes {out['fsync_4KiB_median_ms']:.3f} ms (median)")
    return out


def drive_set(label: str, bodies: dict, card: str, mesh=None,
              with_burst: bool = False):
    """PUT, GET, degraded GET, heal and GET through the healed drives of
    the 256 MiB object, the packed heal, and (``with_burst``) the packed
    burst, on a fresh 16-drive set; returns the launch counts per phase,
    the shard digests after PUT, the readings and the set (still open,
    drives removed)."""
    from minio_tpu_torch.ops import rs_kernels
    root = tempfile.mkdtemp(prefix="chip-smoke-drives-")
    readings = {}
    try:
        er = new_set(root, mesh)
        reset_counts()
        s0 = snapshot()

        t0 = time.perf_counter()
        for name, body in bodies.items():
            t1 = time.perf_counter()
            info = er.put_object("smoke", name, body)
            readings[f"put_{name}_s"] = time.perf_counter() - t1
            check(info.etag == hashlib.md5(body).hexdigest(), f"etag {name}")
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        s_put = snapshot()
        readings["pipeline_256MiB"] = dict(er.pipe_stats)
        shards = {name: shard_digests(er, name) for name in bodies}

        big = bodies["256MiB"]
        for name, body in bodies.items():
            t1 = time.perf_counter()
            _, got = er.get_object("smoke", name)
            readings[f"get_{name}_s"] = time.perf_counter() - t1
            digest = hashlib.sha256(got).digest()
            check(digest == hashlib.sha256(body).digest(), f"GET {name}")
            if len(body) > 2:
                lo, ln = len(body) // 3, max(1, len(body) // 5)
                _, got = er.get_object("smoke", name, lo, ln)
                check(got == body[lo:lo + ln], f"range GET {name}")
        fi, _ = er._read_quorum_fileinfo("smoke", "256MiB")
        victims = victims_of(er, "256MiB")
        part = f"256MiB/{fi.data_dir}/part.1"
        saved = {d: open(f"{root}/d{d}/smoke/{part}", "rb").read()
                 for d in victims}
        wipe(root, "256MiB", victims)
        a_before = rs_kernels.COUNTS.launches
        t0 = time.perf_counter()
        _, got = er.get_object("smoke", "256MiB")
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        check(got == big, "degraded GET 256MiB")
        check(rs_kernels.COUNTS.launches > a_before,
              "degraded GET launched no Kernel A")
        s_get = snapshot()

        t0 = time.perf_counter()
        res = er.heal_object("smoke", "256MiB")
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t0
        s_heal = snapshot()
        check(len(res.healed_disks) == M, f"healed {res.healed_disks}")
        for d in victims:
            check(open(f"{root}/d{d}/smoke/{part}", "rb").read() == saved[d],
                  f"healed part.1 on drive {d} differs")
        # the healed drives must serve: wipe four others and GET again
        wipe(root, "256MiB",
             [d for d in range(K + M) if d not in victims][:M])
        _, got = er.get_object("smoke", "256MiB")
        check(got == big, "GET through healed drives")
        s_heal_get = snapshot()

        packed_heal_s = packed_heal(er, root, bodies[PACKED])
        s_packed = snapshot()
        phases = {"put": delta(s0, s_put), "get": delta(s_put, s_get),
                  "heal": delta(s_get, s_heal),
                  "packed_heal": delta(s_heal_get, s_packed)}
        if with_burst:
            readings["burst"] = burst(er, root, card)
            phases["burst"] = delta(s_packed, snapshot())
        s_end = snapshot()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    total = delta(s0, s_end)
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"{label}: {kernel} plain version ran {plain} "
              "times")
    put_bytes = sum(len(b) for b in bodies.values())
    readings.update(put_bytes=put_bytes, put_s=put_s, degraded_get_s=get_s,
                    heal_s=heal_s, packed_heal_s=packed_heal_s)
    print(f"{label} on {card}: PUT {put_bytes / put_s / 2**30:.3f} GiB/s "
          f"({put_bytes} bytes in {put_s:.3f} s), degraded GET of 256 MiB "
          f"{len(big) / get_s / 2**30:.3f} GiB/s ({get_s:.3f} s), heal of 4 "
          f"shards {heal_s:.3f} s, heal of 4 packed shards of {PACKED} "
          f"{packed_heal_s:.3f} s")
    print(f"{label} launches per phase (kernel, plain): "
          + json.dumps(phases))
    return phases, total, shards, readings, er


def phase_path(bodies: dict, card: str):
    phases, total, shards, readings, er = drive_set("path", bodies, card,
                                                    with_burst=True)
    for phase, counts in phases.items():
        for kernel in ("gf8_apply", "hh256"):
            check(counts[kernel][0] > 0,
                  f"{kernel} not launched during {phase}")
    check(all(layout == "packed" for layout, _ in shards[PACKED].values()),
          f"{PACKED} not packed on every drive")
    readings["breakdown"] = put_breakdown("path", er, bodies["256MiB"],
                                          readings, card)
    er.close()
    return {k: v[0] for k, v in total.items()}, shards, readings


def fused_launches(bodies: dict, batch: int, stream_bytes: int) -> int:
    """Kernel C launches a mesh PUT of ``bodies`` needs: per encode call
    (the whole body up to ``stream_bytes``, else each stream batch), one
    for its full blocks and one for a short last block."""
    count = 0
    for body in bodies.values():
        step = len(body) if len(body) <= stream_bytes else batch
        for off in range(0, len(body), max(1, step)):
            nfull, tail = divmod(min(step, len(body) - off), BLOCK)
            count += (nfull > 0) + (tail > 0)
    return count


def phase_mesh_path(bodies: dict, card: str, ref_shards: dict):
    from minio_tpu_torch.objectlayer import erasure_object
    from minio_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh([torch.device("cuda", 0)])
    phases, total, shards, readings, er = drive_set("mesh path", bodies,
                                                    card, mesh=mesh)
    for name in bodies:
        check(shards[name] == ref_shards[name],
              f"mesh set shards of {name} differ from the first set's")
    want = fused_launches(bodies, er._batch_bytes(),
                          erasure_object.STREAM_BATCH_BYTES)
    check(phases["put"]["rs_fused"][0] == want,
          f"mesh PUT launched Kernel C {phases['put']['rs_fused'][0]} "
          f"times, expected {want}")
    for kernel in ("gf8_apply", "hh256"):
        check(phases["put"][kernel][0] == 0,
              f"{kernel} launched during the mesh PUT")
        for phase in ("get", "heal", "packed_heal"):
            check(phases[phase][kernel][0] > 0,
                  f"{kernel} not launched during the mesh {phase}")
    print(f"mesh path: shards of {len(ref_shards)} objects (part files, "
          f"packed extents, inline data) equal to the first set's on every "
          f"drive; Kernel C launched {want} times during PUT")
    readings["breakdown"] = put_breakdown("mesh path", er, bodies["256MiB"],
                                          readings, card)
    er.close()
    return {k: v[0] for k, v in total.items()}, readings


def put_breakdown(label: str, er, body: bytes, readings: dict,
                  card: str) -> dict:
    """One 60 MiB stream batch's PUT stages timed alone: the host MD5,
    encode + frame on the card (host-to-device copy and the kernels), the
    device-to-host copy into a pinned pooled buffer; and the 256 MiB
    PUT's pipeline wall time per batch, its MD5 and encode + frame
    stages overlapped with the drive writes."""
    from minio_tpu_torch.utils import bufpool
    batch = body[:er._batch_bytes()]
    for _ in range(2):                               # warm, pool filled
        _, release = er._encode_framed_pooled(batch)
        release()
    t0 = time.perf_counter()
    hashlib.md5(batch).hexdigest()
    md5_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    framed = er._frame(batch)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, release = er._to_host(framed)
    copy_s = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    framed.cpu().numpy()
    pageable_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, release = er._encode_framed_pooled(batch)
    pooled_s = time.perf_counter() - t0
    release()
    pipe = readings["pipeline_256MiB"]
    out = {"batch_bytes": len(batch), "md5_ms": md5_s * 1e3,
           "frame_ms": frame_s * 1e3, "d2h_pinned_ms": copy_s * 1e3,
           "d2h_pageable_ms": pageable_s * 1e3,
           "encode_frame_pooled_ms": pooled_s * 1e3,
           "pipeline_wall_ms_per_batch": pipe["wall_s"] * 1e3
           / pipe["batches"],
           "pipeline_md5_ms_per_batch": pipe["md5_s"] * 1e3
           / pipe["batches"],
           "pipeline_encode_ms_per_batch": pipe["encode_s"] * 1e3
           / pipe["batches"], "pipeline_batches": pipe["batches"],
           "pool_hits": bufpool.GLOBAL.hits}
    print(f"{label} PUT stages for one {len(batch)}-byte batch on {card}: "
          f"MD5 {out['md5_ms']:.1f} ms; encode + frame into a pinned pooled "
          f"buffer {out['encode_frame_pooled_ms']:.1f} ms (on the card incl. "
          f"the host-to-device copy {out['frame_ms']:.1f} ms, device-to-host "
          f"into pinned memory {out['d2h_pinned_ms']:.1f} ms, into fresh "
          f"pageable memory {out['d2h_pageable_ms']:.1f} ms); the 256 MiB "
          f"PUT's pipeline: {pipe['batches']} batches, "
          f"{out['pipeline_wall_ms_per_batch']:.1f} ms wall per batch, MD5 "
          f"{out['pipeline_md5_ms_per_batch']:.1f} ms and encode + frame "
          f"{out['pipeline_encode_ms_per_batch']:.1f} ms per batch beside "
          "the drive writes")
    return out


S3_KEY, S3_SECRET = "smoke-key", "smoke-secret"


def http_burst(endpoint: str, bodies: list) -> float:
    """PUT ``bodies`` as ``burst/<i>`` over HTTP from BURST_THREADS
    client threads at once; returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from minio_tpu_torch.s3.client import S3Client

    def put_many(t):
        client = S3Client(endpoint, S3_KEY, S3_SECRET)
        for i in range(t, len(bodies), BURST_THREADS):
            r = client.put_object("smoke", f"burst/{i}", bodies[i])
            etag = hashlib.md5(bodies[i]).hexdigest()
            check(r.headers["ETag"] == f'"{etag}"', f"HTTP burst ETag {i}")

    with ThreadPoolExecutor(BURST_THREADS) as pool:
        t0 = time.perf_counter()
        list(pool.map(put_many, range(BURST_THREADS)))
        return time.perf_counter() - t0


def phase_s3(bodies: dict, card: str, inproc: dict):
    """The S3 front over HTTP on a fresh 16-drive set; returns the launch
    counts and the readings."""
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.server_main import build_server
    root = tempfile.mkdtemp(prefix="chip-smoke-s3-")
    srv = build_server([f"{root}/d{i}" for i in range(K + M)],
                       "127.0.0.1:0", S3_KEY, S3_SECRET, BLOCK,
                       device="cuda")
    er, = srv.layer.sets
    check((er.data_blocks, er.parity, er.device.type) == (K, M, "cuda"),
          f"the server's set is {er.data_blocks} + {er.parity} on "
          f"{er.device}")
    srv.start()
    readings = {}
    try:
        client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        client.make_bucket("smoke")
        reset_counts()
        s0 = snapshot()
        for name, body in bodies.items():
            url = f"{srv.endpoint}/smoke/{name}"
            creds = sigv4.Credentials(S3_KEY, S3_SECRET)
            if name == "256MiB":
                # aws-chunked with Content-MD5: the streaming route
                hdrs, wire = sigv4.sign_request_streaming(
                    creds, "PUT", url, {"Content-MD5": base64.b64encode(
                        hashlib.md5(body).digest()).decode()}, body)
            else:
                hdrs, wire = sigv4.sign_request(creds, "PUT", url, {},
                                                body), body
            t0 = time.perf_counter()
            r = client.send("PUT", url, wire, hdrs)
            readings[f"put_{name}_s"] = time.perf_counter() - t0
            check(r.headers["ETag"] == f'"{hashlib.md5(body).hexdigest()}"',
                  f"HTTP PUT ETag {name}")
            if name == "256MiB":
                readings["pipeline_256MiB"] = dict(er.pipe_stats)
        torch.cuda.synchronize()
        s_put = snapshot()
        for name, body in bodies.items():
            t0 = time.perf_counter()
            got = client.get_object("smoke", name).body
            readings[f"get_{name}_s"] = time.perf_counter() - t0
            check(got == body, f"HTTP GET {name}")
            if len(body) > 2:
                lo, ln = len(body) // 3, max(1, len(body) // 5)
                r = client.get_object("smoke", name, (lo, lo + ln - 1))
                check(r.status == 206 and r.body == body[lo:lo + ln],
                      f"HTTP range GET {name}")
        s_get = snapshot()
        head = client.head_object("smoke", "block+1")
        check(int(head.headers["Content-Length"]) == BLOCK + 1, "HTTP HEAD")
        page = client.list_objects("smoke", delimiter="/")
        check(sorted(o["key"] for o in page["objects"]) == sorted(bodies)
              and page["prefixes"] == [], f"ListObjectsV2: {page}")
        big = bodies["256MiB"]
        wipe(root, "256MiB", victims_of(er, "256MiB"))
        t0 = time.perf_counter()
        got = client.get_object("smoke", "256MiB").body
        readings["degraded_get_s"] = time.perf_counter() - t0
        check(got == big, "HTTP degraded GET 256MiB")
        s_deg = snapshot()
        client.delete_object("smoke", "256MiB")
        check(client.list_objects("smoke", prefix="256")["objects"] == [],
              "HTTP DELETE 256MiB")
        s_del = snapshot()
        burst = burst_bodies()
        wall = http_burst(srv.endpoint, burst)
        for i, body in enumerate(burst):
            check(client.get_object("smoke", f"burst/{i}").body == body,
                  f"HTTP burst object {i} reads back")
        s_end = snapshot()
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    phases = {"put": delta(s0, s_put), "get": delta(s_put, s_get),
              "degraded_get": delta(s_get, s_deg),
              "burst": delta(s_del, s_end)}
    total = delta(s0, s_end)
    n = len(burst)
    readings.update(
        put_256MiB_gib_s=len(big) / readings["put_256MiB_s"] / 2**30,
        get_256MiB_gib_s=len(big) / readings["get_256MiB_s"] / 2**30,
        burst_wall_s=wall, burst_objects_per_s=n / wall)
    inproc_put = len(big) / inproc["put_256MiB_s"] / 2**30
    inproc_get = len(big) / inproc["get_256MiB_s"] / 2**30
    readings["in_process"] = {
        "put_256MiB_gib_s": inproc_put, "get_256MiB_gib_s": inproc_get,
        "degraded_get_s": inproc["degraded_get_s"],
        "burst_objects_per_s": inproc["burst"]["objects_per_s"]}
    print(f"S3 front on {card}: 256 MiB PUT (aws-chunked, Content-MD5) "
          f"{readings['put_256MiB_gib_s']:.3f} GiB/s "
          f"({readings['put_256MiB_s']:.3f} s; in-process "
          f"{inproc_put:.3f} GiB/s, {inproc['put_256MiB_s']:.3f} s), GET "
          f"{readings['get_256MiB_gib_s']:.3f} GiB/s "
          f"({readings['get_256MiB_s']:.3f} s; in-process "
          f"{inproc_get:.3f} GiB/s, {inproc['get_256MiB_s']:.3f} s), "
          f"degraded GET {readings['degraded_get_s']:.3f} s (in-process "
          f"{inproc['degraded_get_s']:.3f} s), burst of {n} x {BURST_SIZE} B "
          f"from {BURST_THREADS} client threads "
          f"{readings['burst_objects_per_s']:.1f} objects/s (in-process "
          f"{inproc['burst']['objects_per_s']:.1f} objects/s)")
    pipes = {"HTTP": readings["pipeline_256MiB"],
             "in-process": inproc["pipeline_256MiB"]}
    print("256 MiB PUT pipeline per batch on " + card + ": " + "; ".join(
        f"{label} {p['wall_s'] * 1e3 / p['batches']:.1f} ms wall, waiting "
        f"on the body {p['body_wait_s'] * 1e3 / p['batches']:.1f} ms, MD5 "
        f"{p['md5_s'] * 1e3 / p['batches']:.1f} ms, encode + frame "
        f"{p['encode_s'] * 1e3 / p['batches']:.1f} ms"
        for label, p in pipes.items()))
    print("S3 path launches per phase (kernel, plain): "
          + json.dumps(phases))
    # a healthy GET verifies (Kernel B) and rebuilds nothing: Kernel A
    # runs in the degraded GET, as in phase 5's GET phase
    for phase, kernels in (("put", ("gf8_apply", "hh256")),
                           ("get", ("hh256",)),
                           ("degraded_get", ("gf8_apply", "hh256")),
                           ("burst", ("gf8_apply", "hh256"))):
        for kernel in kernels:
            check(phases[phase][kernel][0] > 0,
                  f"{kernel} not launched during the S3 {phase}")
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"S3 path: {kernel} plain version ran {plain} "
              "times")
    return {k: v[0] for k, v in total.items()}, readings


MP_PART, MP_PARTS, MP_WORKERS = 16 << 20, 32, 4    # minio-go's defaults


def part_files(root: str, bucket: str, key: str, drives) -> dict:
    """{(drive, file name): bytes} of the object's part files."""
    import glob
    out = {}
    for d in drives:
        for path in sorted(glob.glob(f"{root}/d{d}/{bucket}/{key}/*/part.*")):
            with open(path, "rb") as f:
                out[(d, os.path.basename(path))] = f.read()
    return out


def phase_multipart(card: str, gen) -> tuple:
    """Multipart and versioning over HTTP on a fresh set, then the mesh
    set's multipart upload; returns the launches and the readings."""
    import glob
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.client import S3Client, multipart_etag
    from minio_tpu_torch.server_main import build_server
    root = tempfile.mkdtemp(prefix="chip-smoke-mp-")
    srv = build_server([f"{root}/d{i}" for i in range(K + M)],
                       "127.0.0.1:0", S3_KEY, S3_SECRET, BLOCK,
                       device="cuda")
    er, = srv.layer.sets
    srv.start()
    readings, steps = {}, {}
    body = rand_bytes((MP_PART * MP_PARTS,), gen).cpu().numpy().tobytes()
    md5 = hashlib.md5(body).hexdigest()
    try:
        client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        client.make_bucket("smoke")
        # what the client spends signing one part (aws-chunked), alone
        t0 = time.perf_counter()
        sigv4.sign_request_streaming(
            sigv4.Credentials(S3_KEY, S3_SECRET), "PUT",
            f"{srv.endpoint}/smoke/mp?partNumber=1&uploadId=x", {},
            body[:MP_PART])
        sign_s = time.perf_counter() - t0
        reset_counts()
        s0 = snapshot()
        # 1-2: the upload, ListParts, complete
        t0 = time.perf_counter()
        uid, parts, part_s = client.upload_parts("smoke", "mp", body,
                                                 MP_PART, MP_WORKERS)
        upload_s = time.perf_counter() - t0
        stages = {k: float(np.mean([st[k] for st in er.part_stats]))
                  for k in er.part_stats[0]}
        want_etags = [hashlib.md5(body[o:o + MP_PART]).hexdigest()
                      for o in range(0, len(body), MP_PART)]
        listed = client.list_parts("smoke", "mp", uid)
        check([(p["part_number"], p["etag"], p["size"]) for p in listed]
              == [(i + 1, e, MP_PART) for i, e in enumerate(want_etags)],
              "ListParts")
        t0 = time.perf_counter()
        r = client.complete_multipart_upload("smoke", "mp", uid, parts)
        complete_s = time.perf_counter() - t0
        etag = r.xml().findtext(
            "{http://s3.amazonaws.com/doc/2006-03-01/}ETag").strip('"')
        check(etag == multipart_etag(want_etags) and etag.endswith("-32"),
              f"multipart ETag {etag}")
        torch.cuda.synchronize()
        s_put = snapshot()
        # 3: GET and a range across a part and a block boundary
        t0 = time.perf_counter()
        got = client.get_object("smoke", "mp").body
        get_s = time.perf_counter() - t0
        check(hashlib.md5(got).hexdigest() == md5, "multipart GET MD5")
        # from 3 MiB before part 2 to 1 MiB into its second block
        lo, hi = MP_PART - 3 * BLOCK // 10, MP_PART + BLOCK + BLOCK // 10
        r = client.get_object("smoke", "mp", (lo, hi))
        check(r.status == 206 and r.body == body[lo:hi + 1],
              "multipart range across a part and a block boundary")
        s_get = snapshot()
        # 4: degraded GET
        victims = victims_of(er, "mp")
        saved = part_files(root, "smoke", "mp", victims)
        check(len(saved) == M * MP_PARTS, f"{len(saved)} part files")
        wipe(root, "mp", victims)
        t0 = time.perf_counter()
        got = client.get_object("smoke", "mp").body
        degraded_s = time.perf_counter() - t0
        check(hashlib.md5(got).hexdigest() == md5, "multipart degraded GET")
        s_deg = snapshot()
        # 5: heal, the healed part files, GET through the healed drives
        t0 = time.perf_counter()
        res = er.heal_object("smoke", "mp")
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t0
        check(len(res.healed_disks) == M, f"healed {res.healed_disks}")
        check(part_files(root, "smoke", "mp", victims) == saved,
              "healed part files differ from the removed ones")
        del saved
        wipe(root, "mp", [d for d in range(K + M) if d not in victims][:M])
        got = client.get_object("smoke", "mp").body
        check(hashlib.md5(got).hexdigest() == md5,
              "multipart GET through the healed drives")
        del got
        s_heal = snapshot()
        # 6: an aborted upload leaves no staging dir; its parts go one
        # at a time, the time of a part without concurrent ones
        uid2, _, serial_s = client.upload_parts(
            "smoke", "gone", body[:3 * MP_PART], MP_PART, 1)
        client.abort_multipart_upload("smoke", "gone", uid2)
        check(client.list_multipart_uploads("smoke") == []
              and not glob.glob(f"{root}/d*/.mt.sys/multipart/*"),
              "staging left after abort")
        s_abort = snapshot()
        # 7: a versioned bucket
        readings["versioning"] = versioning_steps(client, er, root, body)
        s_ver = snapshot()
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    # 8: the mesh set's multipart upload (Kernel C)
    mesh_parts, mesh_reading = mesh_multipart(body)
    s_mesh = snapshot()
    steps = {"put": delta(s0, s_put), "get": delta(s_put, s_get),
             "degraded_get": delta(s_get, s_deg),
             "heal": delta(s_deg, s_heal), "abort": delta(s_heal, s_abort),
             "versioning": delta(s_abort, s_ver),
             "mesh_put": mesh_parts, "mesh": delta(s_ver, s_mesh)}
    total = delta(s0, s_mesh)
    for step, kernels in (("put", ("gf8_apply", "hh256")),
                          ("get", ("hh256",)),
                          ("degraded_get", ("gf8_apply", "hh256")),
                          ("heal", ("gf8_apply", "hh256")),
                          ("versioning", ("gf8_apply", "hh256")),
                          ("mesh_put", ("rs_fused",))):
        for kernel in kernels:
            check(steps[step][kernel][0] > 0,
                  f"{kernel} not launched during the multipart {step}")
    for kernel in ("gf8_apply", "hh256"):
        check(steps["mesh_put"][kernel][0] == 0,
              f"{kernel} launched during the mesh set's part PUTs")
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"multipart path: {kernel} plain version ran "
              f"{plain} times")
    gib = len(body) / 2**30
    ps = sorted(part_s)
    readings.update(
        upload_s=upload_s, upload_gib_s=gib / upload_s,
        part_p50_s=ps[len(ps) // 2], part_max_s=ps[-1],
        part_stages_mean_s=stages, serial_part_mean_s=float(
            np.mean(serial_s)), client_sign_part_s=sign_s,
        complete_s=complete_s, get_s=get_s, get_gib_s=gib / get_s,
        degraded_get_s=degraded_s, heal_s=heal_s, mesh=mesh_reading,
        launches={k: {n: v[0] for n, v in d.items()}
                  for k, d in steps.items()})
    print(f"multipart on {card}: {len(body) >> 20} MiB as {MP_PARTS} x "
          f"{MP_PART >> 20} MiB parts from "
          f"{MP_WORKERS} client threads (aws-chunked, Content-MD5) in "
          f"{upload_s:.3f} s ({gib / upload_s:.3f} GiB/s), per part p50 "
          f"{readings['part_p50_s']:.3f} s, max {ps[-1]:.3f} s; complete "
          f"{complete_s:.3f} s; GET {get_s:.3f} s ({gib / get_s:.3f} GiB/s), "
          f"degraded GET {degraded_s:.3f} s, heal of 4 drives x "
          f"{MP_PARTS} parts {heal_s:.3f} s; ETag {etag}")
    print(f"a 16 MiB part on {card}: in the server, means over the 32 "
          f"parts (s): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    stages.items() if k != "bytes")
          + f"; one part alone (1 client thread) "
          f"{readings['serial_part_mean_s']:.3f} s; the client's "
          f"aws-chunked signing of one part {sign_s:.3f} s")
    print("multipart launches per step (kernel, plain): "
          + json.dumps(steps))
    return {k: v[0] for k, v in total.items()}, readings


def versioning_steps(client, er, root: str, body: bytes) -> dict:
    """Phase 8's versioned bucket; returns its readings."""
    client.make_bucket("ver")
    client.set_bucket_versioning("ver", True)
    check(client.get_bucket_versioning("ver") == "Enabled", "versioning")
    t0 = time.perf_counter()
    bodies = [body[:100 * 1024], body[:2 * BLOCK + 5]]
    vids = [client.put_object("ver", "k", b).headers["x-amz-version-id"]
            for b in bodies]
    uid, parts, _ = client.upload_parts("ver", "k", body[:2 * MP_PART],
                                        MP_PART, 2)
    r = client.complete_multipart_upload("ver", "k", uid, parts)
    vids.append(r.headers["x-amz-version-id"])
    bodies.append(body[:2 * MP_PART])
    marker = client.delete_object("ver", "k").headers
    check(marker.get("x-amz-delete-marker") == "true", "delete marker")
    for vid, b in zip(vids, bodies):
        check(client.get_object("ver", "k", version_id=vid).body == b,
              f"version {vid} reads back")
    r = client.get_object("ver", "k", expect=(405,))
    check(r.headers.get("x-amz-delete-marker") == "true",
          "GET of the delete marker")
    listed = client.list_object_versions("ver")
    check([(v["version_id"], v["delete_marker"], v["is_latest"])
           for v in listed] == [(marker["x-amz-version-id"], True, True)]
          + [(v, False, False) for v in reversed(vids)],
          f"ListObjectVersions {listed}")
    client.delete_object("ver", "k", version_id=vids[1])
    fi, _ = er._read_quorum_fileinfo("ver", "k", vids[0])
    drive = fi.erasure.distribution.index(1)
    shutil.rmtree(f"{root}/d{drive}/ver/k")
    res = er.heal_object("ver", "k", version_id=vids[0])
    check(len(res.healed_disks) == 1 and er.disks[drive].read_version(
        "ver", "k", vids[0]).version_id == vids[0],
        f"heal of the oldest version: {res}")
    check(client.get_object("ver", "k", version_id=vids[0]).body
          == bodies[0], "the healed version reads back")
    return {"versions": len(vids), "seconds": time.perf_counter() - t0}


def mesh_multipart(body: bytes) -> tuple:
    """In process on the one-device mesh set: a 3 x 5 MiB + 1 MiB upload;
    returns the launches of its part PUTs and the readings."""
    from minio_tpu_torch.parallel.mesh import make_mesh
    root = tempfile.mkdtemp(prefix="chip-smoke-mesh-mp-")
    try:
        er = new_set(root, mesh=make_mesh([torch.device("cuda", 0)]))
        mib = 1 << 20
        sizes = [5 * mib] * 3 + [mib]
        uid = er.new_multipart_upload("smoke", "mmp")
        s0 = snapshot()
        parts, chunks, off = [], {}, 0
        for n, size in enumerate(sizes, 1):
            chunks[n] = body[off:off + size]
            parts.append((n, er.put_object_part("smoke", "mmp", uid, n,
                                                chunks[n]).etag))
            off += len(chunks[n])
        torch.cuda.synchronize()
        launches = delta(s0, snapshot())
        # one for a part's full blocks, one for its short last block
        want = fused_launches(chunks, er._batch_bytes(), er._batch_bytes())
        check(launches["rs_fused"][0] == want,
              f"mesh parts launched Kernel C {launches['rs_fused'][0]} "
              f"times, expected {want}")
        er.complete_multipart_upload("smoke", "mmp", uid, parts)
        check(er.get_object("smoke", "mmp")[1] == body[:off],
              "mesh multipart GET")
        er.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, {"parts": len(sizes), "bytes": off}


SETS_BUCKET, SETS_OBJ, SETS_OBJS, SETS_THREADS = "sets", 16 << 20, 64, 8
SETS_D2H = 12         # 16 MiB PUTs per set in each D2H wait reading


class ThreadPeak:
    """The most threads alive at once, sampled every 20 ms."""

    def __init__(self):
        import threading
        self.peak = threading.active_count()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="smoke-thread-peak")
        self._t.start()

    def _run(self):
        import threading
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, threading.active_count())

    def stop(self) -> int:
        self._stop.set()
        self._t.join()
        return self.peak


def wait_heal_kicks() -> None:
    """Join the heal sweeps that returning drives started."""
    import threading
    for t in threading.enumerate():
        if t.name == "mt-drive-heal-kick":
            t.join(300)


def drive_shards(disk, bucket: str, keys) -> dict:
    """{key: sha256 of the drive's framed shard}: inline data, the packed
    extent, or every part file."""
    out = {}
    for key in keys:
        fi = disk.read_version(bucket, key)
        if fi.inline_data is not None:
            data = fi.inline_data
        elif fi.seg is not None:
            data = disk.read_segment(fi.seg["sid"], fi.seg["off"],
                                     fi.seg["len"])
        else:
            data = b"".join(disk.read_all(
                bucket, f"{key}/{fi.data_dir}/part.{p.number}")
                for p in fi.parts)
        out[key] = hashlib.sha256(data).digest()
    return out


def tree_stat(root: str) -> dict:
    """{path: (size, mtime_ns)} of every file under a drive."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            st = os.stat(p)
            out[os.path.relpath(p, root)] = (st.st_size, st.st_mtime_ns)
    return out


def put_lanes(endpoint: str, bucket: str, lanes: list) -> float:
    """PUT each lane's (key, body) items in order over HTTP, one client
    thread per lane; returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from minio_tpu_torch.s3.client import S3Client

    def worker(items):
        client = S3Client(endpoint, S3_KEY, S3_SECRET)
        for key, body in items:
            r = client.put_object(bucket, key, body)
            check(r.headers["ETag"] == f'"{hashlib.md5(body).hexdigest()}"',
                  f"sets PUT ETag {key}")

    with ThreadPoolExecutor(len(lanes)) as pool:
        t0 = time.perf_counter()
        list(pool.map(worker, lanes))
        return time.perf_counter() - t0


def put_many(endpoint: str, bucket: str, items: list, threads: int) -> float:
    """PUT (key, body) items over HTTP from ``threads`` client threads."""
    return put_lanes(endpoint, bucket,
                     [items[t::threads] for t in range(threads)])


def keys_in_set(layer, prefix: str, s: int, count: int) -> list:
    """The first ``count`` names ``prefix``NNN that hash to set ``s``."""
    return [k for k in (f"{prefix}{i:03d}" for i in range(1000))
            if layer.get_hashed_set_index(k) == s][:count]


def get_many(endpoint: str, bucket: str, items: list, threads: int) -> float:
    from concurrent.futures import ThreadPoolExecutor
    from minio_tpu_torch.s3.client import S3Client

    def worker(t):
        client = S3Client(endpoint, S3_KEY, S3_SECRET)
        for key, body in items[t::threads]:
            check(client.get_object(bucket, key).body == body,
                  f"sets GET {key}")

    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(worker, range(threads)))
        return time.perf_counter() - t0


def d2h_ms(er) -> float:
    waits = list(er.d2h_waits)
    return float(np.mean(waits)) * 1e3 if waits else float("nan")


def phase_sets(bodies: dict, card: str, gen, single: dict):
    """Two sets of 16 drives behind ``build_server`` over HTTP: placement,
    reads, listing, drive health and heal-on-return; returns the launches
    and the readings."""
    from minio_tpu_torch.s3 import sigv4
    from minio_tpu_torch.s3.client import S3Client, multipart_etag
    from minio_tpu_torch.server_main import build_server
    from minio_tpu_torch.storage.format import FormatErasure
    from minio_tpu_torch.utils import bufpool
    n = 2 * (K + M)
    root = tempfile.mkdtemp(prefix="chip-smoke-sets-")
    phase_t0 = time.perf_counter()
    laps: dict = {}

    def lap(step: str) -> None:
        laps[step] = time.perf_counter() - phase_t0 - sum(laps.values())

    peak = ThreadPeak()
    srv = build_server([f"{root}/d{i}" for i in range(n)], "127.0.0.1:0",
                       S3_KEY, S3_SECRET, BLOCK, device="cuda")
    layer = srv.layer
    readings, steps = {}, {}
    big = bodies["256MiB"]
    blob = rand_bytes((SETS_OBJS * SETS_OBJ,), gen).cpu().numpy().tobytes()
    objs = [(f"obj/{i:02d}", blob[i * SETS_OBJ:(i + 1) * SETS_OBJ])
            for i in range(SETS_OBJS)]
    try:
        check((layer.set_count, layer.set_drive_count) == (2, K + M),
              f"{layer.set_count} sets of {layer.set_drive_count}")
        for s in layer.sets:
            check((s.data_blocks, s.parity, s.device.type) == (K, M, "cuda"),
                  f"a set is {s.data_blocks} + {s.parity} on {s.device}")
        fmts = [FormatErasure.from_json(open(
            f"{root}/d{i}/.mt.sys/format.json", "rb").read())
            for i in range(n)]
        grid = fmts[0].sets
        check(len({f.id for f in fmts}) == 1 and fmts[0].id ==
              layer.deployment_id, "one deployment id on every drive")
        check(len(grid) == 2 and all(len(r) == K + M for r in grid)
              and [f.this for f in fmts] == [u for r in grid for u in r],
              "a 2 x 16 grid, each drive its own place")
        srv.start()
        client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        r = client.request("GET", "/minio/health/cluster", sign=False)
        check(r.status == 200 and r.headers["X-Minio-Write-Quorum"] == str(K),
              f"health at start: {r.status} {r.headers}")
        client.make_bucket(SETS_BUCKET)
        lap("setup")
        reset_counts()
        s0 = snapshot()
        # writes: 16 MiB objects over both sets, then over set 0 alone
        for s in layer.sets:
            s.d2h_waits.clear()
        put_s = put_many(srv.endpoint, SETS_BUCKET, objs, SETS_THREADS)
        # set 0's D2H wait alone, then with set 1 as busy beside it: 12
        # PUTs of 16 MiB per set from 4 client threads per set
        lanes = SETS_THREADS // 2

        def d2h_items(prefix, s):
            return [(k, objs[i][1]) for i, k in
                    enumerate(keys_in_set(layer, prefix, s, SETS_D2H))]
        alone = d2h_items("alone/", 0)
        beside = d2h_items("beside/", 0) + d2h_items("beside/", 1)
        for s in layer.sets:
            s.d2h_waits.clear()
        alone_s = put_many(srv.endpoint, SETS_BUCKET, alone, lanes)
        check(len(layer.sets[1].d2h_waits) == 0, "set 1 busy while alone")
        alone_ms = d2h_ms(layer.sets[0])
        alone_n = len(layer.sets[0].d2h_waits)
        for s in layer.sets:
            s.d2h_waits.clear()
        put_lanes(srv.endpoint, SETS_BUCKET,
                  [beside[:SETS_D2H][t::lanes] for t in range(lanes)]
                  + [beside[SETS_D2H:][t::lanes] for t in range(lanes)])
        both = [d2h_ms(s) for s in layer.sets]
        both_n = [len(s.d2h_waits) for s in layer.sets]
        for key, _ in beside:
            client.delete_object(SETS_BUCKET, key)
        url = f"{srv.endpoint}/{SETS_BUCKET}/big"
        hdrs, wire = sigv4.sign_request_streaming(
            sigv4.Credentials(S3_KEY, S3_SECRET), "PUT", url,
            {"Content-MD5": base64.b64encode(
                hashlib.md5(big).digest()).decode()}, big)
        t0 = time.perf_counter()
        client.send("PUT", url, wire, hdrs)
        big_put_s = time.perf_counter() - t0
        del wire
        mp_body = blob[:2 * MP_PART + 1234567]
        uid, parts, _ = client.upload_parts(SETS_BUCKET, "mp", mp_body,
                                            MP_PART, 3)
        r = client.complete_multipart_upload(SETS_BUCKET, "mp", uid, parts)
        etag = r.xml().findtext(
            "{http://s3.amazonaws.com/doc/2006-03-01/}ETag").strip('"')
        check(etag == multipart_etag([e for _, e in parts]), "sets mp ETag")
        torch.cuda.synchronize()
        s_put = snapshot()
        lap("put")
        burst = [(f"burst/{i:03d}", b) for i, b in enumerate(burst_bodies())]
        burst_s = put_many(srv.endpoint, SETS_BUCKET, burst, BURST_THREADS)
        s_burst = snapshot()
        lap("burst")
        everything = objs + alone + [("big", big), ("mp", mp_body)] + burst
        names = sorted(k for k, _ in everything)
        sizes = {k: len(b) for k, b in everything}
        readings["objects_per_set"] = [
            sum(layer.get_hashed_set_index(k) == i for k, _ in objs)
            for i in range(2)]
        check(min(readings["objects_per_set"]) >= SETS_OBJS // 4,
              f"16 MiB objects per set {readings['objects_per_set']}")
        for key in names:
            s = layer.get_hashed_set_index(key)
            where = [d // (K + M) for d in range(n) if os.path.exists(
                f"{root}/d{d}/{SETS_BUCKET}/{key}/xl.meta")]
            check(where == [s] * (K + M), f"{key} on the drives of set "
                  f"{sorted(set(where))}, placed in set {s}")
        lap("placement")
        # reads: every object, then ListObjectsV2 in pages of 25
        get_s = get_many(srv.endpoint, SETS_BUCKET, everything,
                         SETS_THREADS)
        t0 = time.perf_counter()
        check(client.get_object(SETS_BUCKET, "big").body == big, "GET big")
        big_get_s = time.perf_counter() - t0
        lap("get")
        listed, token, pages = [], "", 0
        while True:
            page = client.list_objects(SETS_BUCKET, max_keys=25,
                                       continuation_token=token)
            listed += [o["key"] for o in page["objects"]]
            pages += 1
            if not page["is_truncated"]:
                break
            token = page["next_token"]
        check(listed == names, "ListObjectsV2 in pages of 25")
        lap("list")
        s_get = snapshot()
        del everything
        # health: in each set a drive goes that holds a data shard of the
        # set's first 16 MiB object (a GET reads the k data shards, so only
        # such a drive makes it rebuild); a degraded GET of that object
        # marks the drive offline.  Not one of the drives taken away below.
        away, foreign = [4, 5, 6, 7], K + M + 5
        deg_keys, victims = [], []
        for s in range(2):
            key = next(k for k, _ in objs
                       if layer.get_hashed_set_index(k) == s)
            fi, _ = layer.sets[s]._read_quorum_fileinfo(SETS_BUCKET, key)
            v = next(s * (K + M) + d for d, shard in
                     enumerate(fi.erasure.distribution) if shard <= K
                     and s * (K + M) + d not in away + [foreign])
            deg_keys.append(key)
            victims.append(v)
        hds = [layer.sets[v // (K + M)].disks[v % (K + M)] for v in victims]
        per_set_keys = [[k for k in names
                         if layer.get_hashed_set_index(k) == s]
                        for s in range(2)]
        before = [drive_shards(hd, SETS_BUCKET, per_set_keys[s])
                  for s, hd in enumerate(hds)]
        lap("digests")
        for v in victims:
            shutil.rmtree(f"{root}/d{v}")
        t0 = time.perf_counter()
        for key in deg_keys:
            check(client.get_object(SETS_BUCKET, key).body ==
                  dict(objs)[key], f"degraded GET {key}")
        degraded_s = (time.perf_counter() - t0) / 2
        check(all(hd.offline for hd in hds), "wiped drives not offline")
        s_deg = snapshot()
        lap("degraded_get")
        healed = {0: [], 1: []}         # objects each set's sweeps healed
        for i, s in enumerate(layer.sets):
            def counted(b, key, *a, _heal=s.heal_object, _i=i, **kw):
                healed[_i].append(key)
                return _heal(b, key, *a, **kw)
            s.heal_object = counted
        # four more drives of set 0 away: 11 of 16 online, below the
        # write quorum of 12
        for d in away:
            os.rename(f"{root}/d{d}", f"{root}/away{d}")
            hd = layer.sets[0].disks[d]
            try:
                hd.stat_vol(SETS_BUCKET)
            except OSError:
                pass
            check(hd.offline, f"drive {d} not offline")
        r = client.request("GET", "/minio/health/cluster", sign=False,
                           expect=(503,))
        check(r.headers["X-Minio-Write-Quorum"] == str(K),
              "503 below quorum")
        client.request("GET", "/minio/health/cluster", "maintenance=true",
                       sign=False, expect=(412,))
        for d in away:
            os.rename(f"{root}/away{d}", f"{root}/d{d}")
        layer.monitor.poll_once()
        wait_heal_kicks()
        check(not any(layer.sets[0].disks[d].offline for d in away),
              "returned drives still offline")
        r = client.request("GET", "/minio/health/cluster", sign=False)
        check(r.status == 200, "health after the drives returned")
        # the four returning drives share set 0's sweep: one, or one more
        # for drives that came back while it ran
        sweeps = len(healed[0]) / len(per_set_keys[0])
        check(sweeps in (1, 2) and not healed[1],
              f"{sweeps} sweeps of set 0, {len(healed[1])} objects of set "
              "1 swept, for four returning drives of set 0")
        readings["quorum_sweeps_set0"] = sweeps
        lap("quorum")
        # the two wiped drives return empty: formatted, their sets healed
        for keys in healed.values():
            keys.clear()
        others = {d: tree_stat(f"{root}/d{d}") for d in range(n)
                  if d not in victims}
        s_heal0 = snapshot()
        lap("before_heal")
        for v in victims:
            os.makedirs(f"{root}/d{v}")
        t0 = time.perf_counter()
        layer.monitor.poll_once()
        wait_heal_kicks()
        torch.cuda.synchronize()
        heal_s = time.perf_counter() - t0
        s_heal = snapshot()
        for s in layer.sets:
            del s.heal_object
        rebuilt = 0
        for s, (v, hd) in enumerate(zip(victims, hds)):
            fmt = FormatErasure.from_json(open(
                f"{root}/d{v}/.mt.sys/format.json", "rb").read())
            check(fmt.this == grid[s][v % (K + M)] == hd.get_disk_id()
                  and not hd.offline, f"drive {v} formatted as itself")
            check(sorted(healed[s]) == per_set_keys[s],
                  f"set {s} swept {len(healed[s])} objects")
            after = drive_shards(hd, SETS_BUCKET, per_set_keys[s])
            check(after == before[s], f"drive {v}: healed shards differ")
            rebuilt += sum(sz for sz, _ in tree_stat(f"{root}/d{v}").values())
        check(all(tree_stat(f"{root}/d{d}") == t for d, t in others.items()),
              "a drive that stayed was written by the heal")
        lap("heal")
        # a drive of another deployment in place of one of set 1
        hd = layer.sets[1].disks[foreign - (K + M)]
        shutil.rmtree(f"{root}/d{foreign}")
        try:
            hd.stat_vol(SETS_BUCKET)
        except OSError:
            pass
        check(hd.offline, "removed drive of set 1 not offline")
        os.makedirs(f"{root}/foreign/{SETS_BUCKET}/x")
        with open(f"{root}/foreign/{SETS_BUCKET}/x/data", "wb") as f:
            f.write(b"theirs")
        os.makedirs(f"{root}/foreign/.mt.sys")
        with open(f"{root}/foreign/.mt.sys/format.json", "w") as f:
            f.write(FormatErasure(id="0ther-dep1oyment", this="their-drive",
                                  sets=[["their-drive"]]).to_json())
        os.rename(f"{root}/foreign", f"{root}/d{foreign}")
        theirs = tree_stat(f"{root}/d{foreign}")
        layer.monitor.poll_once()
        wait_heal_kicks()
        key = next(k for k, _ in objs if layer.get_hashed_set_index(k) == 1)
        check(client.get_object(SETS_BUCKET, key).body == dict(objs)[key],
              "GET beside the foreign drive")
        check(hd.offline and tree_stat(f"{root}/d{foreign}") == theirs,
              "the foreign drive was admitted or written")
        out_after = bufpool.GLOBAL.checked_out
        lap("foreign")
        control = phase_control(
            srv, root, card, gen,
            lambda more: phase_listing(srv, root, card, gen,
                                       {**sizes, **more}))
        check(bufpool.GLOBAL.checked_out == 0, "pooled buffers checked out "
              "after phase 10")
    finally:
        srv.stop()
        threads = peak.stop()
        shutil.rmtree(root, ignore_errors=True)
    lap("stop")
    phase_s = time.perf_counter() - phase_t0
    check(out_after == 0, f"{out_after} pooled buffers checked out")
    steps = {"put": delta(s0, s_put), "burst": delta(s_put, s_burst),
             "get": delta(s_burst, s_get),
             "degraded_get": delta(s_get, s_deg),
             "heal": delta(s_heal0, s_heal)}
    total = delta(s0, s_heal)
    for step, kernels in (("put", ("gf8_apply", "hh256")),
                          ("burst", ("gf8_apply", "hh256")),
                          ("get", ("hh256",)),
                          ("degraded_get", ("gf8_apply", "hh256")),
                          ("heal", ("gf8_apply", "hh256"))):
        for kernel in kernels:
            check(steps[step][kernel][0] > 0,
                  f"{kernel} not launched during the sets {step}")
    # each degraded GET rebuilds a lost data shard: one launch for the
    # full stripe, one for the short one
    check(steps["degraded_get"]["gf8_apply"][0] == 2 * len(deg_keys),
          f"Kernel A launched {steps['degraded_get']['gf8_apply'][0]} times "
          f"in {len(deg_keys)} degraded GETs")
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"sets path: {kernel} plain version ran {plain} "
              "times")
    gib = SETS_OBJS * SETS_OBJ / 2**30
    read_gib = (sum(len(b) for _, b in objs) + len(alone) * SETS_OBJ
                + len(big) + len(mp_body) + len(burst) * BURST_SIZE) / 2**30
    readings.update(
        put_16MiB_s=put_s, put_16MiB_gib_s=gib / put_s,
        put_256MiB_s=big_put_s,
        put_256MiB_gib_s=len(big) / big_put_s / 2**30,
        get_s=get_s, get_gib_s=read_gib / get_s,
        get_256MiB_s=big_get_s, get_256MiB_gib_s=len(big) / big_get_s / 2**30,
        degraded_get_s=degraded_s,
        heal_sweep_s=heal_s, heal_rebuilt_bytes=rebuilt,
        heal_gib_s=rebuilt / heal_s / 2**30,
        burst_s=burst_s, burst_objects_per_s=len(burst) / burst_s,
        d2h_wait_ms_set0_alone=alone_ms, d2h_batches_set0_alone=alone_n,
        d2h_wait_ms_both_sets=both, d2h_batches_both_sets=both_n,
        put_set0_alone_s=alone_s, peak_threads=threads,
        bufpool_checked_out_after=out_after, list_pages=pages,
        phase_s=phase_s, step_s=laps,
        launches={k: {name: v[0] for name, v in d.items()}
                  for k, d in steps.items()})
    print(f"sets path on {card}: {phase_s:.1f} s; 2 sets x 16 drives; "
          f"{SETS_OBJS} x 16 MiB "
          f"from {SETS_THREADS} client threads {gib / put_s:.3f} GiB/s "
          f"({put_s:.3f} s, per set {readings['objects_per_set']}); 256 MiB "
          f"PUT {readings['put_256MiB_gib_s']:.3f} GiB/s (one set alone, "
          f"phase 7: {single['put_256MiB_gib_s']:.3f}); GET of all "
          f"{read_gib:.3f} GiB from {SETS_THREADS} threads "
          f"{read_gib / get_s:.3f} GiB/s, 256 MiB alone "
          f"{readings['get_256MiB_gib_s']:.3f} GiB/s (phase 7: "
          f"{single['get_256MiB_gib_s']:.3f}); degraded GET "
          f"of 16 MiB {degraded_s:.3f} s (phase 7, 256 MiB: "
          f"{single['degraded_get_s']:.3f} s); 4 drives of set 0 back: "
          f"{readings['quorum_sweeps_set0']:.0f} sweep(s) of it; heal "
          f"sweep of 2 returned "
          f"drives {heal_s:.3f} s, {rebuilt} B rebuilt "
          f"({readings['heal_gib_s']:.3f} GiB/s); burst "
          f"{readings['burst_objects_per_s']:.1f} objects/s (phase 7: "
          f"{single['burst_objects_per_s']:.1f}); set 0's D2H wait per "
          f"batch alone {alone_ms:.3f} ms ({alone_n} batches), with "
          f"set 1 as busy {both[0]:.3f} ms (set 1 {both[1]:.3f} ms; "
          f"{both_n} batches); peak {threads} threads; {out_after} pooled "
          "buffers out after")
    print("sets path seconds per step: " + json.dumps(laps))
    print("sets launches per step (kernel, plain): " + json.dumps(steps))
    return {k: v[0] for k, v in total.items()}, readings, control


CTL_BUCKET, CTL_OBJ = "control", 16 << 20      # phase 10


def parse_scrape(text: str) -> dict:
    """{(name, ((label, value), ...)): value} of a Prometheus scrape."""
    import re
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        head, value = ln.rsplit(" ", 1)
        name, _, labels = head.partition("{")
        out[(name, tuple(sorted(re.findall(r'(\w+)="([^"]*)"',
                                           labels))))] = float(value)
    return out


def by_label(samples: dict, name: str, label: str) -> dict:
    """{label value: sample} of one family, other labels summed over."""
    out: dict = {}
    for (n, labels), v in samples.items():
        if n == name:
            key = dict(labels)[label]
            out[key] = out.get(key, 0.0) + v
    return out


def version_shards(disk, bucket: str, key: str) -> dict:
    """{version id: sha256 of the drive's part file} for every version of
    ``key`` on one drive."""
    return {fi.version_id: hashlib.sha256(disk.read_all(
        bucket, f"{key}/{fi.data_dir}/part.1")).digest()
        for fi in disk.list_versions(bucket, key)}


def phase_control(srv, root: str, card: str, gen, before_stop):
    """Phase 10 on phase 9's running server: the scrape reconciled with
    the phase's requests, the codec ops and the kernel launches; a live
    ``pipeline depth`` change; both versions of a key healed onto a drive
    through the admin route; ``storageinfo``, ``heal-status``; then
    ``before_stop({key: size})`` with the objects this phase left in
    ``sets`` (phase 12), and ``service?action=stop``.  Returns the
    launches, the readings and what ``before_stop`` returned."""
    from collections import Counter
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.objectlayer.metadata import hash_order
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.server import _api_name
    layer = srv.layer
    client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
    made: Counter = Counter()

    def s3(method, bucket, key="", query=""):
        made[_api_name(method, bucket, key,
                       {query.split("=")[0]: ""} if query else {})] += 1

    readings: dict = {}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    before = parse_scrape(adm.metrics())
    reset_counts()
    s0 = snapshot()
    # a live pipeline change: depth 0 (serial fan-out, no writer plane),
    # then 2 (the writer plane), one 16 MiB PUT under each
    bodies = rand_bytes((3, CTL_OBJ), gen).cpu().numpy()
    put_s, plane_ops = {}, {}
    for depth in ("0", "2"):
        adm.set_config_kv("pipeline", "depth", depth)
        check(adm.get_config_kv("pipeline")["depth"] == depth and all(
            s._pipe_depth == int(depth) for s in layer.sets),
            f"pipeline depth {depth} not live")
        key = f"depth{depth}"
        er = layer.get_hashed_set(key)
        ops0 = sum(st["ops"] for st in er._write_plane.stats().values())
        t0 = time.perf_counter()
        client.put_object(SETS_BUCKET, key, bodies[int(depth) // 2].tobytes())
        s3("PUT", SETS_BUCKET, key)
        put_s[depth] = time.perf_counter() - t0
        plane_ops[depth] = sum(
            st["ops"] for st in er._write_plane.stats().values()) - ops0
        online = sum(not hd.offline for hd in er.disks)
    # one commit op per online drive of the set through the writer plane
    # at depth 2, none at 0
    check(plane_ops == {"0": 0, "2": online},
          f"writer plane ops per PUT at depth 0, 2: {plane_ops}")
    s_depth = snapshot()

    def beside_offline(name):
        dist = hash_order(f"{CTL_BUCKET}/{name}", K + M)
        return any(hd.offline and dist[i] <= K for i, hd in
                   enumerate(layer.sets[layer.get_hashed_set_index(name)]
                             .disks))
    # the key lands in the set of phase 9's foreign (offline) drive, which
    # holds one of its data shards, whatever set the deployment id gives
    # it: its GETs rebuild that shard (Kernel A, counted as matmul ops)
    key = next(n for n in ("k", *(f"k{i}" for i in range(1, 1000)))
               if beside_offline(n))
    # two versions of the key, a drive holding a data shard of the key
    # emptied of it, then the admin heal route
    client.make_bucket(CTL_BUCKET)
    s3("PUT", CTL_BUCKET)
    client.set_bucket_versioning(CTL_BUCKET, True)
    s3("PUT", CTL_BUCKET, query="versioning")
    vids = []
    for i in (1, 2):
        r = client.put_object(CTL_BUCKET, key, bodies[i].tobytes())
        s3("PUT", CTL_BUCKET, key)
        vids.append(r.headers["x-amz-version-id"])
    s_put = snapshot()
    si = layer.get_hashed_set_index(key)
    er = layer.sets[si]
    fi, _ = er._read_quorum_fileinfo(CTL_BUCKET, key)
    d = next(d for d, shard in enumerate(fi.erasure.distribution)
             if shard <= K and not er.disks[d].offline)
    disk = er.disks[d]
    want = version_shards(disk, CTL_BUCKET, key)
    check(sorted(want) == sorted(vids), "both versions on the drive")
    shutil.rmtree(f"{root}/d{si * (K + M) + d}/{CTL_BUCKET}/{key}")
    t0 = time.perf_counter()
    out = adm.heal(CTL_BUCKET)
    torch.cuda.synchronize()
    heal_s = time.perf_counter() - t0
    s_heal = snapshot()
    healed = parse_scrape(adm.metrics())
    check([(o["object"], o["version_id"]) for o in out["objects"]] ==
          [(key, v) for v in vids[::-1]] and
          all(o["healed"] == [disk.endpoint()] for o in out["objects"]),
          f"admin heal answered {out}")
    check(version_shards(disk, CTL_BUCKET, key) == want,
          "healed version shards differ from the drive's before")
    healed_bytes = sum(
        len(disk.read_all(CTL_BUCKET, f"{key}/{v.data_dir}/part.1"))
        for v in disk.list_versions(CTL_BUCKET, key))
    for i, vid in enumerate(vids):
        check(client.get_object(CTL_BUCKET, key, version_id=vid).body ==
              bodies[i + 1].tobytes(), f"GET version {i + 1}")
        s3("GET", CTL_BUCKET, key, "versionId=x")
    torch.cuda.synchronize()
    s_get = snapshot()
    # the sweep, unpaced (a live heal change), then what the admin
    # routes and the scrape say of it
    adm.set_config_kv("heal", "max_sleep", "0s")
    check(srv.healer.pace_s == 0.0, "heal max_sleep not live")
    t0 = time.perf_counter()
    srv.healer.sweep()
    sweep_s = time.perf_counter() - t0
    status = adm.heal_status()
    check(status["sweep"] == srv.healer.stats.to_dict(),
          f"heal-status {status} against {srv.healer.stats}")
    info = adm.storage_info()["disks"]
    check(len(info) == 2 * (K + M) and sum(e["state"] == "ok" for e in info)
          == 2 * (K + M) - 1, "storageinfo: 31 drives ok, the foreign one "
          "offline")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = adm.metrics()
    scrape_ms = (time.perf_counter() - t0) * 1e3
    after = parse_scrape(text)
    s1 = snapshot()

    def gained(name, label, now=after, then=before):
        a, b = by_label(now, name, label), by_label(then, name, label)
        return {k: v - b.get(k, 0.0) for k, v in a.items()
                if v != b.get(k, 0.0)}
    apis = gained("mt_s3_requests_api_total", "api")
    check(apis == dict(made), f"per-API requests {apis} against {made}")
    ops = gained("mt_tpu_ops_total", "op")
    heal_ops = gained("mt_tpu_ops_total", "op", healed, before)
    get_ops = gained("mt_tpu_ops_total", "op", after, healed)
    launches = delta(s0, s1)
    a, b = launches["gf8_apply"][0], launches["hh256"][0]
    # a 16 MiB PUT: one encode, Kernel A for the full block and the short
    # one, Kernel B for their frames; the heal, and the GETs that rebuild
    # the offline drive's data shard: one matmul per Kernel A launch (full
    # and short stripe), Kernel B to verify and frame
    check(set(ops) == {"encode", "matmul"} and ops["encode"] == 4,
          f"codec ops {ops}")
    check(a == 2 * ops["encode"] + ops["matmul"],
          f"Kernel A launched {a} times for codec ops {ops}")
    put_a = delta(s0, s_put)
    check(put_a["gf8_apply"][0] == put_a["hh256"][0] == 2 * 4,
          f"PUT launches {put_a}")
    heal_l = delta(s_put, s_heal)
    check(set(heal_ops) == {"encode", "matmul"} and
          heal_l["gf8_apply"][0] == heal_ops["matmul"] > 0 and
          heal_l["hh256"][0] > 0,
          f"admin heal launches {heal_l} for codec ops {heal_ops}")
    get_l = delta(s_heal, s_get)
    check(set(get_ops) == {"matmul"} and
          get_l["gf8_apply"][0] == get_ops["matmul"] > 0 and
          delta(s_get, s1)["gf8_apply"][0] == 0,
          f"degraded GET launches {get_l} for codec ops {get_ops}")
    for (name, labels), v in after.items():
        if name == "mt_tpu_kernel_seconds_count":
            check(after[("mt_tpu_ops_total", labels)] == v,
                  f"kernel seconds count {v} for {labels}")
    st = srv.healer.stats
    for fam, field in (("mt_heal_objects_scanned_total", st.objects_scanned),
                       ("mt_heal_objects_healed_total", st.objects_healed),
                       ("mt_heal_objects_failed_total", st.objects_failed),
                       ("mt_heal_cycles_total", st.cycles)):
        check(after[(fam, ())] == field, f"{fam} {after[(fam, ())]} "
              f"against the sweep's {field}")
    effs = by_label(after, "mt_put_pipeline_overlap_efficiency", "set")
    check(effs and all(0 < e <= 1 for e in effs.values()),
          f"overlap efficiency {effs}")
    writes = by_label(after, "mt_put_pipeline_writes_total", "drive")
    check(len(writes) == 2 * (K + M) and min(writes.values()) > 0,
          "writer stats of every drive")
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"control plane: {kernel} plain version ran")
    t_after = time.perf_counter()
    after_phase = before_stop({f"depth{d}": CTL_OBJ for d in put_s})
    after_s = time.perf_counter() - t_after
    # stop through the admin route: serve_forever ends
    adm.service_stop()
    check(srv.shutdown.wait(60), "service?action=stop did not stop")
    readings.update(
        scrape_ms=scrape_ms, scrape_bytes=len(text), put_depth0_s=put_s["0"],
        put_depth2_s=put_s["2"], writer_ops_depth0=plane_ops["0"],
        writer_ops_depth2=plane_ops["2"], overlap_efficiency=effs,
        admin_heal_s=heal_s, admin_heal_bytes=healed_bytes,
        admin_heal_gib_s=healed_bytes / heal_s / 2**30,
        sweep_s=sweep_s, sweep_versions=srv.healer.stats.objects_scanned,
        codec_ops=ops, heal_codec_ops=heal_ops, get_codec_ops=get_ops,
        key=key, key_set=si, requests=dict(made),
        phase_s=time.perf_counter() - t_phase - after_s,
        launches={"depth_puts": {k: v[0] for k, v in
                                 delta(s0, s_depth).items()},
                  "version_puts": {k: v[0] for k, v in
                                   delta(s_depth, s_put).items()},
                  "admin_heal": {k: v[0] for k, v in heal_l.items()},
                  "degraded_gets": {k: v[0] for k, v in get_l.items()}})
    print(f"control plane on {card}: scrape {scrape_ms:.2f} ms over "
          f"{2 * (K + M)} drives ({len(text)} B); 16 MiB PUT at pipeline "
          f"depth 0 {put_s['0']:.3f} s, depth 2 {put_s['2']:.3f} s; admin "
          f"heal of 2 versions {heal_s:.3f} s, {healed_bytes} B "
          f"({readings['admin_heal_gib_s']:.3f} GiB/s); sweep of "
          f"{st.objects_scanned} versions {sweep_s:.3f} s; codec ops {ops}, "
          f"Kernel A {a}, Kernel B {b} launches")
    return {k: v[0] for k, v in launches.items()}, readings, after_phase

LIST_PAGE = 25                                       # phase 12
ILM_BUCKET, QUOTA_BUCKET = "ilm", "quota"
QUOTA_LIMIT, QUOTA_OBJ = 32 << 20, 16 << 20
ILM_OBJ = 64 * 1024
EXPIRE_PAST = (b'<LifecycleConfiguration><Rule><ID>exp</ID><Status>Enabled'
               b'</Status><Filter><Prefix>exp/</Prefix></Filter><Expiration>'
               b'<Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>'
               b'</LifecycleConfiguration>')


def list_pages(client, bucket: str) -> tuple:
    """ListObjectsV2 in pages of ``LIST_PAGE``: (keys, seconds to the
    first page, seconds in all, pages)."""
    keys, token, pages, first = [], "", 0, None
    t0 = time.perf_counter()
    while True:
        page = client.list_objects(bucket, max_keys=LIST_PAGE,
                                   continuation_token=token)
        if first is None:
            first = time.perf_counter() - t0
        keys += [o["key"] for o in page["objects"]]
        pages += 1
        if not page["is_truncated"]:
            return keys, first, time.perf_counter() - t0, pages
        token = page["next_token"]


def top_functions(prof, n: int = 10, own: bool = False) -> list:
    """The ``n`` functions of a cProfile with the most cumulative (or,
    with ``own``, own) time: [where, calls, cumulative s, own s]."""
    import pstats
    here = os.getcwd() + os.sep

    def where(f: str) -> str:
        return f[len(here):] if f.startswith(here) else os.path.basename(f)
    st = pstats.Stats(prof).stats
    rows = sorted(st.items(), key=lambda kv: -kv[1][2 if own else 3])[:n]
    return [[f"{where(f)}:{ln}({fn})", nc, round(ct, 4), round(tt, 4)]
            for (f, ln, fn), (_, nc, tt, ct, _) in rows]


def phase_listing(srv, root: str, card: str, gen, expected: dict):
    """Phase 12 on phase 9's server, after phase 10 and before the stop:
    the listing metacache (cold, warm, after a PUT, a profile of the cold
    walk), one crawler cycle's usage against what phases 9 and 10 left in
    ``sets`` (``expected``: key -> size), lifecycle expiry and a hard
    quota.  Returns the launches and the readings."""
    import cProfile
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.objectlayer.metacache import managers_of
    from minio_tpu_torch.s3.client import S3Client
    layer = srv.layer
    client = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
    caches = managers_of(layer)
    nsets = len(caches)
    expected = dict(expected)

    def hits_misses():
        st = [mc.stats() for mc in caches]
        return (sum(x["hits"] for x in st), sum(x["misses"] for x in st))

    def launched(a, b) -> int:
        return sum(v[0] + v[1] for v in delta(a, b).values())

    readings: dict = {}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    s0 = snapshot()
    names = sorted(expected)
    # cold: phase 10's PUTs invalidated the bucket, phase 9's listing
    # left its blocks on the drives; drop both, so every set walks
    for mc in caches:
        mc.invalidate(SETS_BUCKET)
    hm0 = hits_misses()
    keys, cold_first, cold_s, pages = list_pages(client, SETS_BUCKET)
    check(keys == names, f"cold listing: {len(keys)} keys, want "
          f"{len(names)}")
    hm1 = hits_misses()
    check(hm1[1] - hm0[1] == nsets, f"cold listing: {hm1[1] - hm0[1]} "
          f"walks for {nsets} sets")
    keys, warm_first, warm_s, _ = list_pages(client, SETS_BUCKET)
    check(keys == names, "warm listing")
    hm2 = hits_misses()
    check(hm2[1] == hm1[1] and hm2[0] - hm1[0] == pages * nsets,
          f"warm listing: {hm2[0] - hm1[0]} hits, {hm2[1] - hm1[1]} misses "
          f"over {pages} pages")
    check(cold_s + warm_s < 15.0, "the warm listing ran past the TTL")
    s_list = snapshot()
    check(launched(s0, s_list) == 0, "a listing launched a kernel")
    client.put_object(SETS_BUCKET, "zz-after", b"z" * 1000)
    expected["zz-after"] = 1000
    names = sorted(expected)
    hm3 = hits_misses()
    keys, after_first, after_s, _ = list_pages(client, SETS_BUCKET)
    check(keys == names, "listing after a PUT")
    hm4 = hits_misses()
    # the set the PUT landed in invalidated its snapshot, and the
    # tracker's mark of the bucket made every other set's stale
    check(hm4[1] - hm3[1] == nsets, f"listing after a PUT: "
          f"{hm4[1] - hm3[1]} walks for {nsets} sets")
    # the cold walk under cProfile, in this process (host side)
    for mc in caches:
        mc.invalidate(SETS_BUCKET)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    page = layer.list_objects(SETS_BUCKET, max_keys=LIST_PAGE)
    prof.disable()
    profiled_s = time.perf_counter() - t0
    check([o.name for o in page.objects] == names[:LIST_PAGE],
          "profiled first page")
    top, top_own = top_functions(prof), top_functions(prof, own=True)
    print("cold listing profile, top 10 by cumulative seconds "
          "[function, calls, cumulative s, own s]: " + json.dumps(top))
    print("cold listing profile, top 10 by own seconds: "
          + json.dumps(top_own))
    # one crawler cycle: the usage of ``sets``
    s_crawl0 = snapshot()
    t0 = time.perf_counter()
    srv.crawler.run_cycle()
    cycle_s = time.perf_counter() - t0
    check(launched(s_crawl0, snapshot()) == 0, "a crawl launched a kernel")
    usage = adm.data_usage_info()["bucketsUsageInfo"][SETS_BUCKET]
    want = {"objectsCount": len(expected), "versionsCount": len(expected),
            "size": sum(expected.values())}
    check({k: usage[k] for k in want} == want,
          f"usage of {SETS_BUCKET} {usage}, want {want}")
    scraped = parse_scrape(adm.metrics())[
        ("mt_bucket_usage_total_bytes", (("bucket", SETS_BUCKET),))]
    check(scraped == want["size"], f"scrape says {scraped} B in "
          f"{SETS_BUCKET}, want {want['size']}")
    # lifecycle: 8 objects under exp/ expire, 2 beside them stay
    client.make_bucket(ILM_BUCKET)
    small = rand_bytes((10, ILM_OBJ), gen).cpu().numpy()
    exp_keys = [f"exp/{i}" for i in range(8)]
    keep_keys = [f"keep/{i}" for i in range(2)]
    for i, key in enumerate(exp_keys + keep_keys):
        client.put_object(ILM_BUCKET, key, small[i].tobytes())
    client.set_bucket_lifecycle(ILM_BUCKET, EXPIRE_PAST)
    s_ilm0 = snapshot()
    t0 = time.perf_counter()
    res = srv.crawler.run_cycle()
    ilm_cycle_s = time.perf_counter() - t0
    check(launched(s_ilm0, snapshot()) == 0, "an expiry launched a kernel")
    gone = sorted(k for b, k, _ in res.expired if b == ILM_BUCKET)
    check(gone == exp_keys, f"expired {gone}")
    check(res.restubbed == [], f"stubs put back: {res.restubbed}")
    check([o["key"] for o in client.list_objects(ILM_BUCKET)["objects"]]
          == keep_keys, "listing after the expiry")
    on_drives = [f"d{d}/{ILM_BUCKET}/{k}" for d in range(2 * (K + M))
                 for k in exp_keys + keep_keys
                 if os.path.exists(f"{root}/d{d}/{ILM_BUCKET}/{k}/xl.meta")]
    check(sorted({p.split("/", 1)[1] for p in on_drives}) ==
          [f"{ILM_BUCKET}/{k}" for k in keep_keys],
          f"after the expiry the drives hold {sorted(set(on_drives))[:4]}")
    # a hard quota of 32 MiB: two 16 MiB PUTs reach it (the limit is
    # inclusive), the third is refused before its body is read
    client.make_bucket(QUOTA_BUCKET)
    adm.set_config_kv("quota", "enable", "on")
    adm.set_bucket_quota(QUOTA_BUCKET, QUOTA_LIMIT)
    qbody = rand_bytes((QUOTA_OBJ,), gen).cpu().numpy().tobytes()
    for i in range(2):
        client.put_object(QUOTA_BUCKET, f"q{i}", qbody)
    check(srv.usage.bucket_size(QUOTA_BUCKET) == 2 * QUOTA_OBJ,
          f"quota view {srv.usage.bucket_size(QUOTA_BUCKET)} B")
    torch.cuda.synchronize()
    ops0 = by_label(parse_scrape(adm.metrics()), "mt_tpu_ops_total", "op")
    s_q0 = snapshot()
    t0 = time.perf_counter()
    r = client.request("PUT", f"/{QUOTA_BUCKET}/q2", body=qbody,
                       expect=(403,))
    refuse_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    s_q1 = snapshot()
    ops1 = by_label(parse_scrape(adm.metrics()), "mt_tpu_ops_total", "op")
    check(r.xml().findtext("Code") == "XMinioAdminBucketQuotaExceeded",
          f"quota refusal {r.status} {r.body[:200]}")
    refused = delta(s_q0, s_q1)
    check(refused["gf8_apply"][0] == refused["hh256"][0] == 0
          and launched(s_q0, s_q1) == 0, f"refused PUT launched {refused}")
    check(ops1 == ops0, f"refused PUT ran codec ops {ops0} -> {ops1}")
    client.request("HEAD", f"/{QUOTA_BUCKET}/q2", expect=(404,))
    total = delta(s0, snapshot())
    for kernel, (_, plain) in total.items():
        check(plain == 0, f"listing path: {kernel} plain version ran")
    check(total["gf8_apply"][0] > 0 and total["hh256"][0] > 0,
          "the phase's PUTs launched no kernel")
    readings.update(
        keys=len(names), pages=pages, sets=nsets,
        cold_first_page_s=cold_first, cold_s=cold_s,
        warm_first_page_s=warm_first, warm_s=warm_s,
        after_put_first_page_s=after_first, after_put_s=after_s,
        warm_hits=hm2[0] - hm1[0], warm_misses=hm2[1] - hm1[1],
        after_put_misses=hm4[1] - hm3[1],
        profiled_first_page_s=profiled_s, profile_top=top,
        profile_top_own=top_own,
        crawl_cycle_s=cycle_s, usage=want, ilm_cycle_s=ilm_cycle_s,
        expired=len(gone), quota_refusal_ms=refuse_ms,
        refused_launches={k: v[0] for k, v in refused.items()},
        phase_s=time.perf_counter() - t_phase,
        launches={k: v[0] for k, v in total.items()})
    print(f"listing and usage on {card}: {len(names)} keys in {pages} "
          f"pages of {LIST_PAGE} over {nsets} sets: cold {cold_s:.3f} s "
          f"(first page {cold_first:.3f} s), warm {warm_s:.3f} s "
          f"({hm2[0] - hm1[0]} hits, {hm2[1] - hm1[1]} misses), after a "
          f"PUT {after_s:.3f} s ({hm4[1] - hm3[1]} walk); profiled cold "
          f"first page {profiled_s:.3f} s; crawler cycle {cycle_s:.3f} s "
          f"({want['objectsCount']} objects, {want['size']} B in "
          f"{SETS_BUCKET}); expiry cycle {ilm_cycle_s:.3f} s, {len(gone)} "
          f"expired; quota refusal {refuse_ms:.2f} ms, launches "
          f"{readings['refused_launches']}; phase "
          f"{readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in total.items()}, readings


ID_OBJ, ID_POST = 16 << 20, 1 << 20                 # phase 11
ALPHA_RW = {"Version": "2012-10-17", "Statement": [{
    "Effect": "Allow", "Action": ["s3:*"],
    "Resource": ["arn:aws:s3:::alpha", "arn:aws:s3:::alpha/*"]}]}


def raw_put(endpoint: str, key: str, body: bytes, sent: int):
    """A signed PUT of ``body`` to ``/alpha/<key>`` that sends only its
    first ``sent`` bytes; the open socket (``sendall`` the rest)."""
    import socket
    import urllib.parse
    from minio_tpu_torch.s3 import sigv4
    url = f"{endpoint}/alpha/{key}"
    hdrs = sigv4.sign_request(sigv4.Credentials(S3_KEY, S3_SECRET), "PUT",
                              url, {"Connection": "close"}, body)
    u = urllib.parse.urlsplit(url)
    head = f"PUT {u.path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in hdrs.items()) + \
        f"Content-Length: {len(body)}\r\n\r\n"
    s = socket.create_connection((u.hostname, u.port))
    s.sendall(head.encode() + body[:sent])
    return s


def read_all(s, timeout: float = 30.0) -> bytes:
    s.settimeout(timeout)
    out = b""
    try:
        while True:
            x = s.recv(1 << 20)
            if not x:
                break
            out += x
    except (ConnectionError, OSError):
        pass
    s.close()
    return out


def phase_identity(card: str, gen):
    """Phase 11 on a fresh ``build_server`` of 16 drives: IAM users,
    sessions and service accounts, SigV2, POST policy and bucket policy
    over HTTP with their kernel launches reconciled against the scrape, a
    denied 16 MiB PUT that launches nothing, the request plane's sheds
    and deadlines, config and IAM sealed on every drive, the drain of
    ``stop()`` and a restart.  Returns the launches and the readings."""
    import threading
    import urllib.request
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.secure.configcrypt import MAGIC
    from minio_tpu_torch.server_main import build_server
    from minio_tpu_torch.utils import bufpool
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-id-")
    dirs = [f"{root}/d{i}" for i in range(K + M)]
    srv = build_server(dirs, "127.0.0.1:0", S3_KEY, S3_SECRET, BLOCK,
                       device="cuda")
    srv.start()
    readings: dict = {}
    bodies = rand_bytes((2, ID_OBJ), gen).cpu().numpy()
    put_body, post_body = bodies[0].tobytes(), bodies[1, :ID_POST].tobytes()
    root_c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)

    def ops_now():
        return by_label(parse_scrape(adm.metrics()), "mt_tpu_ops_total",
                        "op")

    def on_drives(bucket, key):
        return [d for d in dirs if os.path.exists(f"{d}/{bucket}/{key}")]
    try:
        for b in ("alpha", "beta"):
            root_c.make_bucket(b)
        adm.add_policy("alpha-rw", ALPHA_RW)
        adm.add_user("u1", "u1-secret-key", ["alpha-rw"])
        u1 = S3Client(srv.endpoint, "u1", "u1-secret-key")
        torch.cuda.synchronize()
        reset_counts()
        s0, ops0 = snapshot(), ops_now()
        # 1: the user's 16 MiB PUT and GET
        t0 = time.perf_counter()
        u1.put_object("alpha", "obj", put_body)
        torch.cuda.synchronize()
        readings["user_put_s"] = time.perf_counter() - t0
        s_put, ops_put = snapshot(), ops_now()
        t0 = time.perf_counter()
        check(u1.get_object("alpha", "obj").body == put_body,
              "user GET byte-exact")
        readings["user_get_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        s_get = snapshot()
        put_l = delta(s0, s_put)
        gained = {k: v - ops0.get(k, 0) for k, v in ops_put.items()
                  if v != ops0.get(k, 0)}
        # a 16 MiB PUT: one encode of a full and a short block, Kernels
        # A and B once for each
        check(gained == {"encode": 1} and put_l["gf8_apply"][0] ==
              put_l["hh256"][0] == 2, f"user PUT launches {put_l}, "
              f"codec ops {gained}")
        get_l = delta(s_put, s_get)
        check(get_l["gf8_apply"][0] == 0 and get_l["hh256"][0] > 0,
              f"user GET launches {get_l}")
        # 2: a denied 16 MiB PUT launches nothing and leaves nothing
        r = u1.request("PUT", "/beta/denied", body=put_body, expect=())
        torch.cuda.synchronize()
        s_denied = snapshot()
        check(r.status == 403 and r.xml().findtext("Code") ==
              "AccessDenied", f"denied PUT answered {r.status}")
        check(delta(s_get, s_denied) == {k: (0, 0) for k in KERNELS} and
              ops_now() == ops_put, "the denied PUT launched a kernel")
        check(on_drives("beta", "denied") == [], "denied PUT left a trace")
        # 3: an STS session bounded to GetObject; a service account
        sess = u1.assume_role(900, {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:GetObject"],
             "Resource": ["arn:aws:s3:::*"]}]})
        check(sess.get_object("alpha", "obj").body == put_body,
              "session GET")
        check(sess.request("PUT", "/alpha/sess", body=b"x",
                           expect=()).status == 403, "session PUT refused")
        sa = adm.add_service_account("u1")
        sac = S3Client(srv.endpoint, sa["accessKey"], sa["secretKey"])
        check(sac.put_object("alpha", "sa", post_body).status == 200,
              "service-account PUT")
        # 4: SigV2, POST policy, bucket policy
        check(u1.request_v2("GET", "/alpha/sa").body == post_body,
              "SigV2 header-signed GET")
        with urllib.request.urlopen(u1.presign_v2("GET", "alpha", "sa"),
                                    timeout=60) as resp:
            check(resp.read() == post_body, "SigV2 presigned GET")
        r = u1.post_object("alpha", "post/obj", post_body,
                           [["content-length-range", 0, ID_POST]])
        check(r.status == 204 and root_c.get_object(
            "alpha", "post/obj").body == post_body, "POST-policy upload")
        root_c.set_bucket_policy("alpha", {
            "Version": "2012-10-17", "Statement": [{
                "Effect": "Allow", "Principal": {"AWS": ["*"]},
                "Action": ["s3:GetObject"],
                "Resource": ["arn:aws:s3:::alpha/pub/*"]}]})
        root_c.put_object("alpha", "pub/x", post_body)
        anon = S3Client(srv.endpoint, "", "")
        check(anon.request("GET", "/alpha/pub/x", sign=False).body ==
              post_body, "anonymous GET the bucket policy allows")
        check(anon.request("PUT", "/alpha/pub/y", body=b"z", sign=False,
                           expect=()).status == 403,
              "anonymous PUT refused")
        torch.cuda.synchronize()
        s_feat = snapshot()
        # 5a: the governor sheds a PUT whose framed shards pass mem_limit
        shed0 = parse_scrape(adm.metrics()).get(
            ("mt_mem_shed_total", (("kind", "commit"),)), 0.0)
        # below the object's framed shards, which parity makes larger
        adm.set_config_kv("api", "mem_limit", str(ID_OBJ))
        t0 = time.perf_counter()
        r = root_c.request("PUT", "/alpha/shed", body=put_body, expect=())
        readings["mem_shed_s"] = time.perf_counter() - t0
        shed1 = parse_scrape(adm.metrics()).get(
            ("mt_mem_shed_total", (("kind", "commit"),)), 0.0)
        adm.set_config_kv("api", "mem_limit", "0")
        check(r.status == 503 and r.xml().findtext("Code") == "SlowDown"
              and r.headers.get("Retry-After") == "1" and shed1 == shed0 + 1
              and on_drives("alpha", "shed") == [],
              f"memory shed: {r.status} {r.headers.get('Retry-After')} "
              f"shed {shed0} -> {shed1}")
        # 5b: a full request pool sheds while health and scrape answer
        for k, v in (("requests_max", "1"), ("requests_queue", "1"),
                     ("requests_deadline", "1s")):
            adm.set_config_kv("api", k, v)
        small = put_body[:4096]
        held = raw_put(srv.endpoint, "held", small, 100)
        time.sleep(0.3)
        shed: list = []

        def one(i):
            t = time.perf_counter()
            r = root_c.request("PUT", f"/alpha/q{i}", body=small, expect=())
            shed.append((r.status, r.headers.get("Retry-After"),
                         time.perf_counter() - t))
        ts = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        live = root_c.request("GET", "/minio/health/live", sign=False,
                              expect=()).status
        scrape = len(adm.metrics())
        for t in ts:
            t.join(30)
        held.sendall(small[100:])
        held_status = read_all(held).split(b"\r\n")[0]
        for k, v in (("requests_max", "64"), ("requests_queue", "0"),
                     ("requests_deadline", "10s")):
            adm.set_config_kv("api", k, v)
        n503 = [x for x in shed if x[0] == 503 and x[1] == "1"]
        check(n503 and live == 200 and scrape > 0 and
              held_status == b"HTTP/1.1 200 OK",
              f"pool shed {shed}, live {live}, held {held_status}")
        readings["pool_shed_s"] = min(x[2] for x in n503)
        # 5c: a body that stalls after 1 MiB is cut with 408
        adm.set_config_kv("api", "body_deadline", "1s")
        adm.set_config_kv("api", "body_min_rate", "0")
        t0 = time.perf_counter()
        slow = raw_put(srv.endpoint, "slow", put_body, 1 << 20)
        answer = read_all(slow, 10)
        readings["timeout_s"] = time.perf_counter() - t0
        adm.set_config_kv("api", "body_deadline", "5m")
        adm.set_config_kv("api", "body_min_rate", "1048576")
        deadline = time.monotonic() + 10
        while bufpool.GLOBAL.checked_out and time.monotonic() < deadline:
            time.sleep(0.05)
        check(answer.startswith(b"HTTP/1.1 408") and
              readings["timeout_s"] < 3 and
              bufpool.GLOBAL.checked_out == 0 and
              on_drives("alpha", "slow") == [],
              f"stalled body: {answer[:40]!r} after "
              f"{readings['timeout_s']:.2f} s, "
              f"{bufpool.GLOBAL.checked_out} buffers out")
        # 6: sealed at rest on every drive
        for d in dirs:
            for name in ("iam.json", "config.json"):
                with open(f"{d}/.mt.sys/config/{name}", "rb") as f:
                    check(f.read(len(MAGIC)) == MAGIC,
                          f"{d} {name} not sealed")
        # stop() drains a GET in flight
        import socket
        from minio_tpu_torch.s3 import sigv4
        url = f"{srv.endpoint}/alpha/obj"
        hdrs = sigv4.sign_request(sigv4.Credentials(S3_KEY, S3_SECRET),
                                  "GET", url, {})
        g = socket.create_connection(("127.0.0.1", srv.port))
        g.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 65536)
        g.sendall(("GET /alpha/obj HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode())
        first = g.recv(65536)
        stopper = threading.Thread(target=srv.stop)
        stopper.start()
        time.sleep(0.3)
        draining = stopper.is_alive()
        got = first + read_all(g)
        stopper.join(60)
        check(draining and not stopper.is_alive() and
              got.split(b"\r\n\r\n", 1)[1] == put_body,
              "stop() did not drain the GET in flight")
    finally:
        srv.stop()
    # a restart on the same drives keeps identities and knobs
    t0 = time.perf_counter()
    srv2 = build_server(dirs, "127.0.0.1:0", S3_KEY, S3_SECRET, BLOCK,
                        device="cuda")
    readings["restart_build_s"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        srv2.iam.load()
        readings["restart_iam_load_s"] = time.perf_counter() - t0
        srv2.start()
        check(S3Client(srv2.endpoint, "u1", "u1-secret-key").get_object(
            "alpha", "obj").body == put_body, "u1 after the restart")
        check(S3Client(srv2.endpoint, sa["accessKey"], sa["secretKey"])
              .get_object("alpha", "sa").body == post_body,
              "service account after the restart")
        check(srv2.config.get("api", "requests_max") == "64" and
              srv2._req_max == 64 and srv2.body_deadline_s == 300.0,
              "api knobs after the restart")
        torch.cuda.synchronize()
        s2 = snapshot()
    finally:
        srv2.stop()
    launches = delta(s0, s2)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"identity path: {kernel} plain version ran")
    for kernel in ("gf8_apply", "hh256"):
        check(delta(s_denied, s_feat)[kernel][0] > 0,
              f"{kernel} not launched by the features' PUTs and GETs")
    readings.update(
        phase_s=time.perf_counter() - t_phase,
        launches={"user_put": {k: v[0] for k, v in put_l.items()},
                  "user_get": {k: v[0] for k, v in get_l.items()},
                  "denied_put": {k: v[0] for k, v in
                                 delta(s_get, s_denied).items()},
                  "features": {k: v[0] for k, v in
                               delta(s_denied, s_feat).items()}})
    print(f"identity path on {card}: user {ID_OBJ / 2**20:g} MiB PUT "
          f"{readings['user_put_s']:.3f} s, GET {readings['user_get_s']:.3f}"
          f" s; memory shed {readings['mem_shed_s']:.3f} s; pool shed "
          f"{readings['pool_shed_s']:.4f} s; 408 after "
          f"{readings['timeout_s']:.3f} s; restart iam.load "
          f"{readings['restart_iam_load_s']:.4f} s; phase "
          f"{readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings


POOLS_OBJ, POOLS_SMALL = 16 << 20, 512 * 1024           # phase 13
POOLS_FIRST, POOLS_MORE, POOLS_THREADS = 16, 32, 4
POOLS_DRAIN_LIMIT_S = 120.0


def pools_pool(dirs: list):
    """One pool of phase 13: one 12 + 4 set with 10 MiB blocks on the
    card (``soak/chaos.py``'s layer 0)."""
    from minio_tpu_torch.objectlayer.sets import ErasureSets
    return ErasureSets.from_dirs(dirs, 1, K + M, block_size=BLOCK,
                                 device="cuda")


def pools_server(dirs0: list, load: bool = False):
    """Pool 0 under ``ErasureServerPools`` behind an S3Server, with the
    tracker, the crawler and a rebalancer (0.25 s, threshold 0.05)
    attached, as ``minio_tpu/soak/chaos.py`` builds a pooled node; with
    ``load`` the manifest brings back the pools recorded on pool 0."""
    from minio_tpu_torch.background.crawler import Crawler
    from minio_tpu_torch.background.rebalance import Rebalancer
    from minio_tpu_torch.background.tracker import DataUpdateTracker
    from minio_tpu_torch.objectlayer.pools import ErasureServerPools
    from minio_tpu_torch.s3.server import S3Server
    layer = ErasureServerPools([pools_pool(dirs0)], secret=S3_SECRET)
    if load:
        check(layer.load_manifest(), "no pool manifest on pool 0")
    srv = S3Server(layer, access_key=S3_KEY, secret_key=S3_SECRET,
                   host="127.0.0.1", port=0)
    srv.iam.load()
    tracker = DataUpdateTracker()
    srv.attach_tracker(tracker)
    srv.crawler = Crawler(layer, bucket_meta=srv.bucket_meta,
                          interval_s=24 * 3600.0, tracker=tracker)
    srv.attach_background(srv.crawler, rebalancer=Rebalancer(
        layer, interval_s=0.25, threshold=0.05))
    srv.reload_pipeline_config()
    srv.reload_commit_config()
    srv.start()
    return srv


def pools_identity(client, bucket: str, key: str, vid=None) -> tuple:
    """(ETag, version id, Last-Modified) a HEAD answers."""
    h = {k.lower(): v for k, v in
         client.head_object(bucket, key, version_id=vid).headers.items()}
    return (h.get("etag"), h.get("x-amz-version-id"), h.get("last-modified"))


def rebalance_threads() -> list:
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith("mt-rebalance")]


def phase_pools(card: str, gen):
    """Phase 13: a 16-drive pool grown by two more over HTTP, the middle
    one decommissioned under traffic and retired, usage per pool, and a
    restart from pool 0's manifest; every body, ETag, version id and
    Last-Modified checked across it.  Returns the launches and the
    readings."""
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.s3.client import S3Client, multipart_etag
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-pools-")
    dirs = [[f"{root}/p{j}/d{i}" for i in range(K + M)] for j in range(3)]
    for d in (d for ds in dirs for d in ds):
        os.makedirs(d)
    blob = rand_bytes((POOLS_FIRST + POOLS_MORE + 4, POOLS_OBJ), gen) \
        .cpu().numpy()
    big = [blob[i].tobytes() for i in range(len(blob))]
    small = rand_bytes((16, POOLS_SMALL), gen).cpu().numpy()
    readings: dict = {}
    want: dict = {}          # (bucket, key, vid or None) -> body
    srv = pools_server(dirs[0])
    try:
        layer = srv.layer
        c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
        for b in ("pools", "poolsv"):
            c.make_bucket(b)
        c.set_bucket_versioning("poolsv", True)
        first = [(f"n{i:03d}", big[i]) for i in range(POOLS_FIRST)]
        torch.cuda.synchronize()
        reset_counts()
        s0 = snapshot()
        # 1: one pool
        t = put_many(srv.endpoint, "pools", first, POOLS_THREADS)
        torch.cuda.synchronize()
        s_put1 = snapshot()
        readings["put_1pool_gibps"] = len(first) * POOLS_OBJ / t / 2**30
        put_many(srv.endpoint, "pools", [(f"s{i:02d}", small[i].tobytes())
                                         for i in range(len(small))],
                 POOLS_THREADS)
        mp_body = b"".join(big[POOLS_FIRST + POOLS_MORE:][:3])
        uid, parts, _ = c.upload_parts("pools", "mp", mp_body, POOLS_OBJ,
                                       POOLS_THREADS)
        r = c.complete_multipart_upload("pools", "mp", uid, parts)
        etag = r.xml().findtext(
            "{http://s3.amazonaws.com/doc/2006-03-01/}ETag").strip('"')
        check(etag == multipart_etag([e for _, e in parts]) and
              etag.endswith("-3"), f"multipart ETag {etag}")
        want.update({("pools", k, None): v for k, v in first})
        want.update({("pools", f"s{i:02d}", None): small[i].tobytes()
                     for i in range(len(small))})
        want[("pools", "mp", None)] = mp_body

        def versions(key, bodies, marker=False):
            """Versions of ``key`` in ``poolsv``, then a delete marker."""
            for body in bodies:
                h = {k.lower(): v for k, v in c.put_object(
                    "poolsv", key, body).headers.items()}
                want[("poolsv", key, h["x-amz-version-id"])] = body
            if marker:
                c.delete_object("poolsv", key)
        versions("ver", [small[0].tobytes(), small[1].tobytes()])
        versions("gone", [small[2].tobytes()], marker=True)
        # 2: grow by two pools
        for j in (1, 2):
            check(adm.pool_add(dirs[j], 1, K + M, block_size=BLOCK) ==
                  {"status": "ok", "pool": j}, f"pool-add {j}")
        st = adm.pool_status()["pools"]
        check([p["status"] for p in st] == ["active"] * 3,
              f"pool-status after the adds: {st}")
        ids = [p["id"] for p in st]
        # what a PUT of a new name now pays first: a probe of each pool
        t0 = time.perf_counter()
        for i in range(20):
            check(layer.get_pool_idx("pools", f"probe{i}") in (0, 1, 2),
                  "placement")
        readings["probe_3pools_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        more = [(f"n{i:03d}", big[i])
                for i in range(POOLS_FIRST, POOLS_FIRST + POOLS_MORE)]
        torch.cuda.synchronize()
        s_put3a = snapshot()
        t = put_many(srv.endpoint, "pools", more, POOLS_THREADS)
        torch.cuda.synchronize()
        s_put3 = snapshot()
        readings["put_3pools_gibps"] = len(more) * POOLS_OBJ / t / 2**30
        want.update({("pools", k, None): v for k, v in more})
        held = {j: sorted(o.name for o in layer.pools[j].list_objects(
            "pools", "n", max_keys=1000).objects) for j in range(3)}
        readings["new_keys_per_pool"] = [
            len([k for k, _ in more if k in held[j]]) for j in range(3)]
        check(all(readings["new_keys_per_pool"]),
              f"a pool received none of the new keys: {held}")
        # versions and a delete marker placed on pool 1
        on1 = [k for k in (f"v{i:03d}" for i in range(200))
               if layer.get_pool_idx("poolsv", k) == 1][:2]
        versions(on1[0], [small[5].tobytes(), small[6].tobytes()])
        versions(on1[1], [small[7].tobytes()], marker=True)
        # an upload pinned to pool 1
        up = next(k for k in (f"up{i:03d}" for i in range(200))
                  if layer.get_pool_idx("pools", k) == 1)
        up_uid = c.create_multipart_upload("pools", up)
        up_parts = [(1, c.upload_part("pools", up, up_uid, 1,
                                      big[-1]))]
        # a shard lost in each pool: the GET rebuilds it (Kernel A)
        for j in range(3):
            key = held[j][0]
            er = layer.pools[j].get_hashed_set(key)
            fi, _ = er._read_quorum_fileinfo("pools", key)
            d = fi.erasure.distribution.index(1)
            os.remove(f"{dirs[j][d]}/pools/{key}/{fi.data_dir}/part.1")
        items = [(k, v) for (b, k, vid), v in want.items()
                 if b == "pools" and len(v) == POOLS_OBJ]
        torch.cuda.synchronize()
        s_get3a = snapshot()
        t = get_many(srv.endpoint, "pools", items, POOLS_THREADS)
        torch.cuda.synchronize()
        s_get3 = snapshot()
        readings["get_3pools_gibps"] = len(items) * POOLS_OBJ / t / 2**30
        ident = {k: pools_identity(c, b, key, vid)
                 for k in want for (b, key, vid) in [k]}
        listing_v = c.list_object_versions("poolsv")
        # 3: decommission pool 1 under traffic; each move timed
        from minio_tpu_torch.background import rebalance as rb_mod
        moves: list = []
        real_move = rb_mod.move_version

        def timed_move(*a, **kw):
            t0 = time.perf_counter()
            n = real_move(*a, **kw)
            moves.append((time.perf_counter() - t0, n))
            return n

        rb_mod.move_version = timed_move
        moved0 = dict(srv.rebalancer.stats.to_dict())
        torch.cuda.synchronize()
        s_dr0 = snapshot()
        t_dr = time.perf_counter()
        check(adm.pool_decommission(1) == {"status": "draining", "pool": 1},
              "pool-decommission")
        up_parts.append((2, c.upload_part("pools", up, up_uid, 2,
                                          small[8].tobytes())))
        c.complete_multipart_upload("pools", up, up_uid, up_parts)
        up_body = big[-1] + small[8].tobytes()
        want[("pools", up, None)] = up_body
        # an overwrite of pool 1's last key, placed on an active pool
        victim = held[1][-1]
        new_body = small[9].tobytes()
        c.put_object("pools", victim, new_body)
        now = layer.pools
        readings["stale_copy_beside_overwrite"] = len(now) == 3 and any(
            o.name == victim for o in now[1].list_objects(
                "pools", victim).objects)
        check(c.get_object("pools", victim).body == new_body,
              "GET after an overwrite beside the draining copy")
        want[("pools", victim, None)] = new_body
        while len(adm.pool_status()["pools"]) == 3:
            check(time.perf_counter() - t_dr < POOLS_DRAIN_LIMIT_S,
                  "pool 1 not retired within the limit")
            time.sleep(0.1)
        drain_s = time.perf_counter() - t_dr
        rb_mod.move_version = real_move
        torch.cuda.synchronize()
        s_dr = snapshot()
        st = adm.pool_status()["pools"]
        check([p["id"] for p in st] == [ids[0], ids[2]],
              f"pool-status after the drain: {st}")
        rs = adm.rebalance_status()["stats"]
        scrape = parse_scrape(adm.metrics())
        moved = (rs["movedObjects"] - moved0["movedObjects"],
                 rs["movedBytes"] - moved0["movedBytes"])
        check(moved[0] > 0 and (rs["movedObjects"], rs["movedBytes"]) == (
            scrape[("mt_rebalance_moved_objects_total", ())],
            scrape[("mt_rebalance_moved_bytes_total", ())]),
            f"rebalance-status {rs} against the scrape")
        check(rs["failed"] == 0, f"failed moves: {rs}")
        readings.update(
            drain_s=drain_s, drain_moved_objects=moved[0],
            drain_moved_bytes=moved[1],
            drain_gibps=moved[1] / drain_s / 2**30,
            drain_cycles=rs["cycles"] - moved0["cycles"],
            drain_moves=len(moves),
            drain_in_moves_s=sum(t for t, _ in moves),
            move_16mib_s=[round(t, 4) for t, n in moves
                          if n == POOLS_OBJ])
        # nothing of an object left on pool 1: no file outside the
        # system volume, no staged part
        left = [p for d in dirs[1] for dp, _, fs in os.walk(d) for f in fs
                for p in [os.path.relpath(os.path.join(dp, f), d)]
                if not p.startswith(".mt.sys/")
                or p.startswith(".mt.sys/multipart/")]
        check(left == [], f"pool 1's drives hold object data: {left[:4]}")
        # every key, version and marker, as before
        for (b, key, vid), body in want.items():
            got = c.get_object(b, key, version_id=vid).body
            check(got == body, f"{b}/{key}@{vid} body after the drain")
            if (b, key, vid) in ident and key not in (victim,):
                check(pools_identity(c, b, key, vid) ==
                      ident[(b, key, vid)], f"{b}/{key}@{vid} identity")
        check(c.list_object_versions("poolsv") == listing_v,
              "the versions listing after the drain")
        check(ident[("pools", "mp", None)][0].strip('"').endswith("-3"),
              "multipart ETag")
        # 4: usage per pool
        srv.crawler.run_cycle()
        scrape = parse_scrape(adm.metrics())
        usage = by_label(scrape, "mt_pool_usage_bytes", "pool")
        written = sum(len(v) for v in want.values())
        check(sorted(usage) == sorted([ids[0], ids[2]]) and
              sum(usage.values()) == written,
              f"mt_pool_usage_bytes {usage} against {written} written")
        st = adm.pool_status()["pools"]
        check(all("usedBytes" in p and "objects" in p for p in st),
              f"pool-status without usage: {st}")
        readings["pool_usage_bytes"] = [int(usage[i]) for i in
                                        (ids[0], ids[2])]
    finally:
        srv.stop()
    check(rebalance_threads() == [], "a rebalance thread outlived stop()")
    # 5: a restart from pool 0's drives alone
    t0 = time.perf_counter()
    srv = pools_server(dirs[0], load=True)
    try:
        readings["restart_s"] = time.perf_counter() - t0
        check([sp.pool_id for sp in srv.layer.specs] == [ids[0], ids[2]],
              "the pools after the restart")
        c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        for (b, key, vid), body in want.items():
            check(c.get_object(b, key, version_id=vid).body == body,
                  f"{b}/{key}@{vid} after the restart")
        torch.cuda.synchronize()
        s_end = snapshot()
    finally:
        srv.stop()
    check(rebalance_threads() == [], "a rebalance thread outlived stop()")
    shutil.rmtree(root, ignore_errors=True)
    launches = delta(s0, s_end)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"pools path: {kernel} plain version ran")
    steps = {"put_1pool": delta(s0, s_put1), "put_3pools": delta(s_put3a,
                                                                  s_put3),
             "get_3pools": delta(s_get3a, s_get3), "drain": delta(s_dr0,
                                                                   s_dr)}
    for step, got in steps.items():
        for kernel in ("gf8_apply", "hh256"):
            check(got[kernel][0] > 0, f"{kernel} not launched in {step}")
    readings.update(
        phase_s=time.perf_counter() - t_phase,
        launches={step: {k: v[0] for k, v in got.items()}
                  for step, got in steps.items()})
    print(f"pools path on {card}: PUT {readings['put_1pool_gibps']:.3f} "
          f"GiB/s on one pool, {readings['put_3pools_gibps']:.3f} on three;"
          f" GET {readings['get_3pools_gibps']:.3f} GiB/s; drain "
          f"{drain_s:.2f} s, {moved[0]} objects, "
          f"{readings['drain_gibps']:.3f} GiB/s; restart "
          f"{readings['restart_s']:.3f} s; phase {readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings


S3_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"
COPY_OBJ, COPY_N, COPY_THREADS = 16 << 20, 8, 4            # phase 14
SSE_OBJ, TEXT_OBJ, RRS_PART = 16 << 20, 4 << 20, 5 << 20   # phase 15
SSE_S3 = {"x-amz-server-side-encryption": "AES256"}
RRS = {"x-amz-storage-class": "REDUCED_REDUNDANCY"}
COPY_PARTS_MIB = (100, 100, 56)          # part ranges of the 256 MiB body
LOCK_N, TAG_N = 4, 16


def copy_many(endpoint: str, items: list, threads: int) -> float:
    """CopyObject of (source bucket, source key, bucket, key, body) items
    over HTTP from ``threads`` client threads, each ETag the body's MD5;
    returns the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    from minio_tpu_torch.s3.client import S3Client

    def worker(t):
        client = S3Client(endpoint, S3_KEY, S3_SECRET)
        for sb, sk, b, k, data in items[t::threads]:
            r = client.copy_object(b, k, sb, sk)
            etag = r.xml().findtext(f"{S3_NS}ETag")
            check(etag == f'"{hashlib.md5(data).hexdigest()}"',
                  f"copy ETag {b}/{k}")

    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(worker, range(threads)))
        return time.perf_counter() - t0


def s3_code(fn) -> str:
    """The S3 error code ``fn()`` answers (it must fail)."""
    from minio_tpu_torch.s3.client import S3ClientError
    try:
        fn()
    except S3ClientError as e:
        return e.code
    raise AssertionError("the request was not refused")


def phase_copy_lock(bodies: dict, card: str, gen):
    """Phase 14: CopyObject and UploadPartCopy, tagging and object lock
    on phase 9's deployment (``build_server`` on 32 drives: 2 sets of 16)
    over HTTP.  Returns the launches and the readings."""
    import datetime
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.server_main import build_server
    t_phase = time.perf_counter()
    n = 2 * (K + M)
    root = tempfile.mkdtemp(prefix="chip-smoke-copy-")
    srv = build_server([f"{root}/d{i}" for i in range(n)], "127.0.0.1:0",
                       S3_KEY, S3_SECRET, BLOCK, device="cuda")
    srv.start()
    big = bodies["256MiB"]
    blob = rand_bytes((COPY_N + LOCK_N + 2, COPY_OBJ), gen).cpu().numpy()
    objs = [blob[i].tobytes() for i in range(len(blob))]
    readings: dict = {}
    steps: dict = {}
    try:
        layer = srv.layer
        c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        for b in ("copys", "copyd", "copyv"):
            c.make_bucket(b)
        c.set_bucket_versioning("copyv", True)
        srcs = [(f"src/{i}", objs[i]) for i in range(COPY_N)]
        put_many(srv.endpoint, "copys", srcs, COPY_THREADS)
        c.put_object_chunked("copys", "big", big, chunk_size=1 << 20)
        dsts = [f"dst/{i}" for i in range(COPY_N)]
        check({layer.get_hashed_set_index(k) != layer.get_hashed_set_index(
            d) for (k, _), d in zip(srcs, dsts)} == {True, False},
            "copies within a set and across the two")
        torch.cuda.synchronize()
        reset_counts()
        s0 = snapshot()
        # 1: CopyObject of 8 x 16 MiB from 4 threads, then 256 MiB
        t = copy_many(srv.endpoint, [("copys", k, "copyd", d, v) for
                                     (k, v), d in zip(srcs, dsts)],
                      COPY_THREADS)
        readings["copy_16mib_gibps"] = COPY_N * COPY_OBJ / t / 2**30
        t0 = time.perf_counter()
        c.copy_object("copyd", "big", "copys", "big")
        torch.cuda.synchronize()
        readings["copy_256mib_s"] = time.perf_counter() - t0
        s_copy = snapshot()
        steps["copy"] = delta(s0, s_copy)
        for d, (_, v) in zip(dsts, srcs):
            check(c.get_object("copyd", d).body == v, f"copy body {d}")
        check(c.get_object("copyd", "big").body == big, "256 MiB copy body")
        # 2: the directives: REPLACE, then a version copy
        torch.cuda.synchronize()
        s1 = snapshot()
        c.copy_object("copyd", "replaced", "copys", srcs[0][0], headers={
            "x-amz-metadata-directive": "REPLACE",
            "x-amz-tagging-directive": "REPLACE",
            "x-amz-meta-phase": "14", "x-amz-tagging": "phase=14&copy=1"})
        torch.cuda.synchronize()
        s_one = snapshot()
        h = c.head_object("copyd", "replaced").headers
        check(h.get("x-amz-meta-phase") == "14" and
              h.get("x-amz-tagging-count") == "2", f"REPLACE copy: {h}")
        check(c.get_object_tagging("copyd", "replaced") ==
              {"phase": "14", "copy": "1"}, "REPLACE copy's tags")
        vids = [c.put_object("copyv", "k", objs[COPY_N + LOCK_N + i])
                .headers["x-amz-version-id"] for i in range(2)]
        r = c.copy_object("copyd", "fromv", "copyv", "k", version_id=vids[0])
        check(r.headers.get("x-amz-copy-source-version-id") == vids[0],
              "x-amz-copy-source-version-id")
        check(c.get_object("copyd", "fromv").body == objs[COPY_N + LOCK_N],
              "version copy body")
        torch.cuda.synchronize()
        s_dir = snapshot()
        steps["directives"] = delta(s1, s_dir)
        # 3: a degraded source: its four data-shard drives lose it
        key = srcs[1][0]
        er = layer.get_hashed_set(key)
        fi, _ = er._read_quorum_fileinfo("copys", key)
        for d, shard in enumerate(fi.erasure.distribution):
            if shard <= M:
                shutil.rmtree(f"{er.disks[d].endpoint()}/copys/{key}")
        torch.cuda.synchronize()
        s2 = snapshot()
        t0 = time.perf_counter()
        c.copy_object("copyd", "degraded", "copys", key)
        torch.cuda.synchronize()
        readings["degraded_copy_s"] = time.perf_counter() - t0
        s_deg = snapshot()
        steps["degraded_copy"] = delta(s2, s_deg)
        one_a = delta(s1, s_one)["gf8_apply"][0]
        check(steps["degraded_copy"]["gf8_apply"][0] > one_a,
              f"the degraded copy rebuilt nothing: Kernel A "
              f"{steps['degraded_copy']['gf8_apply'][0]} launches against "
              f"{one_a} for a healthy copy")
        check(c.get_object("copyd", "degraded").body == srcs[1][1],
              "degraded copy body")
        # 4: UploadPartCopy of three ranges of the 256 MiB body
        cuts = [0]
        for mib in COPY_PARTS_MIB:
            cuts.append(cuts[-1] + len(big) * mib // 256)
        uid = c.create_multipart_upload("copyd", "parts")
        torch.cuda.synchronize()
        s3 = snapshot()
        t0 = time.perf_counter()
        parts = [(i + 1, c.upload_part_copy(
            "copyd", "parts", uid, i + 1, "copys", "big",
            byte_range=(cuts[i], cuts[i + 1] - 1)))
            for i in range(len(COPY_PARTS_MIB))]
        torch.cuda.synchronize()
        readings["part_copy_s"] = time.perf_counter() - t0
        s_parts = snapshot()
        steps["part_copy"] = delta(s3, s_parts)
        for (num, etag), a, b in zip(parts, cuts, cuts[1:]):
            check(etag == hashlib.md5(big[a:b]).hexdigest(),
                  f"part {num} ETag")
        c.complete_multipart_upload("copyd", "parts", uid, parts)
        check(c.get_object("copyd", "parts").body == big,
              "UploadPartCopy object body")
        # 4b: the 256 MiB body copied onto its own name (REPLACE): the
        # source streams without its read lock, batch by batch
        torch.cuda.synchronize()
        s_self = snapshot()
        t0 = time.perf_counter()
        c.copy_object("copys", "big", "copys", "big", headers={
            "x-amz-metadata-directive": "REPLACE", "x-amz-meta-phase": "14"})
        torch.cuda.synchronize()
        readings["self_copy_256mib_s"] = time.perf_counter() - t0
        steps["self_copy"] = delta(s_self, snapshot())
        check(c.head_object("copys", "big").headers.get("x-amz-meta-phase")
              == "14", "the copy onto its own name: its metadata")
        check(c.get_object("copys", "big").body == big,
              "the copy onto its own name: its body")
        # 5: tagging: PUT, GET and DELETE ?tagging on 16 objects
        # the degraded source is left out: its set lacks it on four drives
        tagged = [("copyd", d) for d in dsts + ["degraded"]] + \
            [("copys", k) for k, _ in srcs if k != key]
        check(len(tagged) == TAG_N, "the objects tagged")
        torch.cuda.synchronize()
        s4 = snapshot()
        t0 = time.perf_counter()
        for i, (b, k) in enumerate(tagged):
            c.put_object_tagging(b, k, {"phase": "14", "n": str(i)})
        for i, (b, k) in enumerate(tagged):
            check(c.get_object_tagging(b, k) == {"phase": "14",
                                                 "n": str(i)}, f"tags {k}")
        for b, k in tagged:
            c.delete_object_tagging(b, k)
        readings["tag_call_ms"] = (time.perf_counter() - t0) \
            / (3 * len(tagged)) * 1e3
        torch.cuda.synchronize()
        s_tag = snapshot()
        steps["tagging"] = delta(s4, s_tag)
        check(all(c.get_object_tagging(b, k) == {} for b, k in tagged),
              "tags deleted")
        # 6: object lock: a 1-day GOVERNANCE default, 4 x 16 MiB
        c.make_bucket("copylock", object_lock=True)
        c.put_object_lock_config("copylock", "GOVERNANCE", days=1)
        until = datetime.datetime.now(datetime.timezone.utc) + \
            datetime.timedelta(days=1)
        lock_objs = objs[COPY_N:COPY_N + LOCK_N]
        lvids = []
        for i, v in enumerate(lock_objs):
            hdrs = {"x-amz-object-lock-mode": "COMPLIANCE",
                    "x-amz-object-lock-retain-until-date":
                        until.strftime("%Y-%m-%dT%H:%M:%SZ")} \
                if i == 1 else None
            lvids.append(c.put_object("copylock", f"l{i}", v, hdrs)
                         .headers["x-amz-version-id"])
        check(c.get_object_retention("copylock", "l0", lvids[0])[0] ==
              "GOVERNANCE", "the default retention")
        c.put_object_legal_hold("copylock", "l2", True, lvids[2])
        torch.cuda.synchronize()
        s5 = snapshot()
        refusals = []
        for key, vid, bypass in (("l0", lvids[0], False),
                                 ("l1", lvids[1], True),
                                 ("l2", lvids[2], True)):
            t0 = time.perf_counter()
            got = s3_code(lambda: c.delete_object(
                "copylock", key, vid, bypass_governance=bypass))
            refusals.append(time.perf_counter() - t0)
            check(got == "ObjectLocked", f"delete of {key}: {got}")
        torch.cuda.synchronize()
        s_ref = snapshot()
        steps["refusals"] = delta(s5, s_ref)
        readings["refusal_ms"] = [round(t * 1e3, 3) for t in refusals]
        c.delete_object("copylock", "l0", lvids[0], bypass_governance=True)
        check(s3_code(lambda: c.get_object("copylock", "l0", version_id=
                                           lvids[0])) == "NoSuchKey",
              "the bypassed delete")
        for i in (1, 2, 3):
            check(c.get_object("copylock", f"l{i}", version_id=lvids[i])
                  .body == lock_objs[i], f"locked version l{i}")
        torch.cuda.synchronize()
        s_end = snapshot()
        transform = phase_transform(srv, card, gen)
        tier_select = phase_tier_select(srv, card)
        events = phase_events(srv, card, gen)
        replication = phase_replication(srv, card, gen)
        brokers = phase_brokers(srv, card, gen)
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    launches = delta(s0, s_end)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"copy and lock path: {kernel} plain version ran")
    for step in ("copy", "directives", "degraded_copy", "part_copy",
                 "self_copy"):
        for kernel in ("gf8_apply", "hh256"):
            check(steps[step][kernel][0] > 0,
                  f"{kernel} not launched in the {step} step")
    for step in ("tagging", "refusals"):
        check(all(v == (0, 0) for v in steps[step].values()),
              f"the {step} step launched a kernel: {steps[step]}")
    readings.update(
        phase_s=time.perf_counter() - t_phase,
        launches={step: {k: v[0] for k, v in got.items()}
                  for step, got in steps.items()})
    print(f"copy and lock path on {card}: copy 8 x 16 MiB "
          f"{readings['copy_16mib_gibps']:.3f} GiB/s, 256 MiB "
          f"{readings['copy_256mib_s']:.3f} s, degraded 16 MiB "
          f"{readings['degraded_copy_s']:.3f} s, part copy "
          f"{readings['part_copy_s']:.3f} s, 256 MiB onto its own name "
          f"{readings['self_copy_256mib_s']:.3f} s; tag call "
          f"{readings['tag_call_ms']:.2f} ms; refusals "
          f"{readings['refusal_ms']} ms; phase {readings['phase_s']:.1f} s")
    return ({k: v[0] for k, v in launches.items()}, readings, transform,
            tier_select, events, replication, brokers)


def text_body(size: int) -> bytes:
    """``size`` bytes of log lines: what the compression subsystem takes
    (a ``.txt`` key) and shrinks."""
    line = b"2026-10-17T10:00:00Z INFO request %08d served in %4d us\n"
    out = b"".join(line % (i, i % 977) for i in range(size // 48 + 1))
    return out[:size]


def timed_step(steps: dict, name: str, fn):
    """fn() between two snapshots after a synchronize; (result, s)."""
    torch.cuda.synchronize()
    before = snapshot()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps[name] = delta(before, snapshot())
    return out, secs


def phase_transform(srv, card: str, gen):
    """Phase 15: storage classes, SSE-S3 and compression over HTTP on the
    running server of phase 14.  Returns the launches and the
    readings."""
    from minio_tpu_torch.s3.client import S3Client
    t_phase = time.perf_counter()
    c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    blob = rand_bytes((3, SSE_OBJ), gen).cpu().numpy()
    sse_body, rrs_body = blob[0].tobytes(), blob[1].tobytes()
    parts = [blob[2][:RRS_PART].tobytes(),
             blob[2][RRS_PART:2 * RRS_PART].tobytes()]
    text = text_body(TEXT_OBJ)
    readings: dict = {}
    steps: dict = {}
    gib = 2 ** 30
    c.make_bucket("transform")
    srv.config.set("compression", "enable", "on")
    try:
        torch.cuda.synchronize()
        s0 = snapshot()
        # 1: SSE-S3, 16 MiB: PUT, GET, a range across DARE packages
        r, t = timed_step(steps, "sse_put", lambda: c.put_object(
            "transform", "sse.dat", sse_body, headers=SSE_S3))
        check(r.headers.get("x-amz-server-side-encryption") == "AES256",
              "SSE-S3 PUT answer")
        readings["sse_put_gibps"] = len(sse_body) / t / gib
        info = srv.layer.get_object_info("transform", "sse.dat")
        check(info.size > len(sse_body) and "x-minio-internal-server-side-"
              "encryption-sealed-key" in info.user_defined,
              "SSE-S3 object stored sealed")
        got, t = timed_step(steps, "sse_get", lambda: c.get_object(
            "transform", "sse.dat"))
        check(got.body == sse_body, "SSE-S3 GET body")
        readings["sse_get_gibps"] = len(sse_body) / t / gib
        lo, hi = SSE_OBJ * 5 // 16 + 3, SSE_OBJ * 9 // 16 - 7
        got, t = timed_step(steps, "sse_range", lambda: c.get_object(
            "transform", "sse.dat", (lo, hi)))
        check(got.body == sse_body[lo:hi + 1], "SSE-S3 ranged GET body")
        readings["sse_range_s"] = t
        # 2: compression, 4 MiB of text
        r, t = timed_step(steps, "compressed_put", lambda: c.put_object(
            "transform", "log.txt", text))
        readings["compressed_put_s"] = t
        readings["compressed_put_mibps"] = len(text) / t / 2 ** 20
        info = srv.layer.get_object_info("transform", "log.txt")
        check(info.size < len(text) // 2, f"compressed to {info.size}")
        readings["compression_ratio"] = len(text) / info.size
        got, t = timed_step(steps, "compressed_get", lambda: c.get_object(
            "transform", "log.txt"))
        check(got.body == text, "compressed GET body")
        readings["compressed_get_s"] = t
        readings["compressed_get_mibps"] = len(text) / t / 2 ** 20
        check(c.head_object("transform", "log.txt").headers[
            "Content-Length"] == str(len(text)), "HEAD plain size")
        # 3: REDUCED_REDUNDANCY, 16 MiB, then degraded
        _, t = timed_step(steps, "rrs_put", lambda: c.put_object(
            "transform", "rrs.dat", rrs_body, headers=RRS))
        readings["rrs_put_gibps"] = len(rrs_body) / t / gib
        er = srv.layer.get_hashed_set("rrs.dat")
        fi, _ = er._read_quorum_fileinfo("transform", "rrs.dat")
        k_rrs = fi.erasure.data_blocks
        check((k_rrs, fi.erasure.parity_blocks) == (K + M - 2, 2),
              f"RRS geometry {k_rrs}+{fi.erasure.parity_blocks}")
        wiped = [d for d, shard in enumerate(fi.erasure.distribution)
                 if shard <= k_rrs][:2]
        for d in wiped:
            shutil.rmtree(f"{er.disks[d].endpoint()}/transform/rrs.dat")
        got, t = timed_step(steps, "rrs_degraded_get", lambda: c.get_object(
            "transform", "rrs.dat"))
        check(got.body == rrs_body, "RRS degraded GET body")
        check(c.head_object("transform", "rrs.dat").headers.get(
            "x-amz-storage-class") == "REDUCED_REDUNDANCY", "RRS HEAD")
        readings["rrs_degraded_get_gibps"] = len(rrs_body) / t / gib
        # 4: a REDUCED_REDUNDANCY upload of 2 x 5 MiB
        def upload():
            uid = c.create_multipart_upload("transform", "rrs-mp",
                                            headers=RRS)
            etags = [c.upload_part("transform", "rrs-mp", uid, n, p)
                     for n, p in enumerate(parts, 1)]
            c.complete_multipart_upload("transform", "rrs-mp", uid,
                                        list(enumerate(etags, 1)))
        _, t = timed_step(steps, "rrs_multipart", upload)
        readings["rrs_multipart_gibps"] = 2 * RRS_PART / t / gib
        check(c.get_object("transform", "rrs-mp").body == b"".join(parts),
              "RRS multipart body")
        check(srv.layer.get_object_info("transform", "rrs-mp").parity == 2,
              "RRS multipart parity")
        torch.cuda.synchronize()
        launches = delta(s0, snapshot())
    finally:
        srv.config.set("compression", "enable", "off")
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"transform path: {kernel} plain version ran")
    for step in ("sse_put", "compressed_put", "rrs_put", "rrs_multipart"):
        for kernel in ("gf8_apply", "hh256"):
            check(steps[step][kernel][0] > 0,
                  f"{kernel} not launched in the {step} step")
    check(steps["rrs_degraded_get"]["gf8_apply"][0] > 0,
          "Kernel A not launched in the RRS degraded GET")
    readings.update(
        phase_s=time.perf_counter() - t_phase,
        launches={step: {k: v[0] for k, v in got.items()}
                  for step, got in steps.items()})
    print(f"transform path on {card}: SSE-S3 16 MiB PUT "
          f"{readings['sse_put_gibps']:.3f} GiB/s, GET "
          f"{readings['sse_get_gibps']:.3f} GiB/s, range "
          f"{readings['sse_range_s']:.3f} s; compressed 4 MiB PUT "
          f"{readings['compressed_put_s']:.2f} s, GET "
          f"{readings['compressed_get_s']:.2f} s (ratio "
          f"{readings['compression_ratio']:.1f}); RRS 16 MiB PUT "
          f"{readings['rrs_put_gibps']:.3f} GiB/s, degraded GET "
          f"{readings['rrs_degraded_get_gibps']:.3f} GiB/s, 2 x 5 MiB "
          f"upload {readings['rrs_multipart_gibps']:.3f} GiB/s; phase "
          f"{readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings


TIER_OBJ, SEL_OBJ, SEL_SEED = 16 << 20, 16 << 20, 20261018    # phase 16
SEL_CITIES = ("paris", "tokyo", "lima", "oslo", "accra", "quito")
SEL_WHERE = ("SELECT s.id, s.amount FROM S3Object s "
             "WHERE CAST(s.amount AS FLOAT) > 500")
SEL_AGG = "SELECT COUNT(*), SUM(CAST(s.amount AS FLOAT)) FROM S3Object s"
SEL_SUM_RTOL = 1e-9
TIER_RULE = (b'<LifecycleConfiguration>' + b''.join(
    b'<Rule><ID>%s</ID><Status>Enabled</Status><Filter><Prefix>%s/'
    b'</Prefix></Filter><Transition><Date>2020-01-01T00:00:00Z</Date>'
    b'<StorageClass>%s</StorageClass></Transition></Rule>' % (t, p, t)
    for t, p in ((b"COLD", b"cold"), (b"REMOTE", b"remote"))) +
    b'</LifecycleConfiguration>')


def select_table(target: int, seed: int) -> tuple:
    """Seeded rows (id, name, amount with two decimals, city) of about
    ``target`` bytes as CSV with a header: (CSV, the same rows as JSON
    lines, the ids, the amounts as floats)."""
    rng = np.random.default_rng(seed)
    n = target // 33
    amounts = [f"{a:.2f}" for a in rng.uniform(0, 1000, n)]
    cities = rng.integers(0, len(SEL_CITIES), n)
    csv_rows = [f"{i},user{i},{amounts[i]},{SEL_CITIES[cities[i]]}\n"
                for i in range(n)]
    json_rows = [f'{{"id":{i},"name":"user{i}","amount":{amounts[i]},'
                 f'"city":"{SEL_CITIES[cities[i]]}"}}\n' for i in range(n)]
    return ("id,name,amount,city\n" + "".join(csv_rows)).encode(), \
        "".join(json_rows).encode(), list(range(n)), \
        [float(a) for a in amounts]


def select_request(expression: str, input_xml: str) -> bytes:
    return ("<SelectObjectContentRequest><Expression>" + expression +
            "</Expression><ExpressionType>SQL</ExpressionType>"
            "<InputSerialization>" + input_xml + "</InputSerialization>"
            "<OutputSerialization><CSV/></OutputSerialization>"
            "</SelectObjectContentRequest>").encode()


def select_answer(body: bytes) -> tuple:
    """(the Records payload, BytesScanned) of a Select's event stream,
    every frame's CRCs checked."""
    from minio_tpu_torch.s3select import message
    events = message.parse_events(body)
    check(events and events[-1][0] == "End",
          f"select stream ends {events[-1:] if events else events}")
    check(not any(t == "error" for t, _ in events), "select error frame")
    stats = [p for t, p in events if t == "Stats"]
    scanned = int(stats[0].split(b"<BytesScanned>")[1].split(b"<")[0])
    return b"".join(p for t, p in events if t == "Records"), scanned


def phase_tier_select(srv, card: str):
    """Phase 16: transitions to a tier and restore, then S3 Select, on the
    running server of phases 14 and 15.  Returns the launches and the
    readings."""
    import gzip
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.objectlayer import tiering
    from minio_tpu_torch.s3.client import S3Client
    t_phase = time.perf_counter()
    c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
    layer = srv.layer
    tier_root = tempfile.mkdtemp(prefix="chip-smoke-tier-")
    rng = np.random.default_rng(SEL_SEED)
    bodies = {key: rng.integers(0, 256, TIER_OBJ, dtype=np.uint8).tobytes()
              for key in ("cold/plain.dat", "cold/sse.dat",
                          "remote/plain.dat")}
    csv_body, jsonl_body, ids, amounts = select_table(SEL_OBJ, SEL_SEED)
    want_where = [(i, a) for i, a in zip(ids, amounts) if a > 500]
    want_count, want_sum = len(ids), sum(amounts)
    readings: dict = {"select_bytes": len(csv_body),
                      "select_jsonl_bytes": len(jsonl_body)}
    steps: dict = {}
    try:
        adm.add_tier({"type": "dir", "name": "COLD",
                      "path": f"{tier_root}/cold"})
        c.make_bucket("tierremote")
        adm.add_tier({"type": "s3", "name": "REMOTE",
                      "endpoint": srv.endpoint, "bucket": "tierremote",
                      "access_key": S3_KEY, "secret_key": S3_SECRET})
        check(sorted(t["name"] for t in adm.list_tiers()) ==
              ["COLD", "REMOTE"], "the tier routes")
        for b in ("tiered", "tiercopy", "sel"):
            c.make_bucket(b)
        etags = {}
        for key, data in bodies.items():
            etags[key] = c.put_object(
                "tiered", key, data,
                headers=SSE_S3 if "sse" in key else None).headers["ETag"]
        stored = {k: hashlib.md5(layer.get_object("tiered", k)[1]).digest()
                  for k in bodies}
        check(stored["cold/sse.dat"] != hashlib.md5(
            bodies["cold/sse.dat"]).digest(), "SSE-S3 stored encrypted")
        c.set_bucket_lifecycle("tiered", TIER_RULE)
        torch.cuda.synchronize()
        reset_counts()
        s0 = snapshot()
        # 1: one crawler cycle transitions the three objects
        moves = []
        transition = srv.crawler.transition_fn

        def timed_transition(*args):
            t0 = time.perf_counter()
            transition(*args)
            torch.cuda.synchronize()
            moves.append(time.perf_counter() - t0)

        srv.crawler.transition_fn = timed_transition
        try:
            res, t = timed_step(steps, "transition", srv.crawler.run_cycle)
        finally:
            srv.crawler.transition_fn = transition
        check(sorted(res.transitioned) == sorted(
            ("tiered", k) for k in bodies), f"transitioned {res.transitioned}")
        check(res.restubbed == [], f"stubs put back: {res.restubbed}")
        readings["transition_s"] = moves
        readings["crawler_cycle_s"] = t
        stub_select = select_request(SEL_AGG, "<CSV/>")
        for key, data in bodies.items():
            check(s3_code(lambda: c.get_object("tiered", key)) ==
                  "InvalidObjectState", f"GET of the stub {key}")
            check(s3_code(lambda: c.request(
                "POST", f"/tiered/{key}", "select&select-type=2",
                stub_select)) == "InvalidObjectState",
                f"Select over the stub {key}")
            h = c.head_object("tiered", key).headers
            check((h["Content-Length"], h["ETag"],
                   h.get("x-amz-storage-class")) ==
                  (str(len(data)), etags[key],
                   "COLD" if key.startswith("cold/") else "REMOTE"),
                  f"HEAD of the stub {key}: {h}")
            er = layer.get_hashed_set(key)
            for d in er.disks:
                left = os.listdir(f"{d.endpoint()}/tiered/{key}")
                check(left == ["xl.meta"], f"{key} on {d.endpoint()}: {left}")
            ud = layer.get_object_info("tiered", key).user_defined
            tier_key = ud[tiering.META_KEY]
            if key.startswith("cold"):
                path = f"{tier_root}/cold/" + tier_key.replace("/", "_")
                with open(path, "rb") as f:
                    held = f.read()
            else:
                held = c.get_object("tierremote", tier_key).body
            check(hashlib.md5(held).digest() == stored[key],
                  f"the tier holds {key}'s stored bytes")
        # 2: restore each (202), then a second time (200)
        restores = []
        for key, data in bodies.items():
            r, t = timed_step(steps, f"restore {key}", lambda: c.request(
                "POST", f"/tiered/{key}", "restore",
                b"<RestoreRequest><Days>1</Days></RestoreRequest>",
                expect=()))
            check(r.status == 202, f"restore of {key}: {r.status}")
            restores.append(t)
            check(c.get_object("tiered", key).body == data,
                  f"GET of the restored {key}")
            r = c.request("POST", f"/tiered/{key}", "restore", expect=())
            check(r.status == 200, f"second restore of {key}: {r.status}")
            check("x-amz-restore" in c.head_object("tiered", key).headers,
                  f"x-amz-restore of {key}")
        readings["restore_s"] = restores
        _, t = timed_step(steps, "copy", lambda: c.copy_object(
            "tiercopy", "copy", "tiered", "cold/plain.dat"))
        readings["copy_restored_s"] = t
        check(c.get_object("tiercopy", "copy").body ==
              bodies["cold/plain.dat"], "copy of the restored stub")
        # 3: the deletes free the tier copies
        for key in bodies:
            ud = layer.get_object_info("tiered", key).user_defined
            c.delete_object("tiered", key)
            tier_key = ud[tiering.META_KEY]
            if key.startswith("cold"):
                check(not os.path.exists(f"{tier_root}/cold/" +
                                         tier_key.replace("/", "_")),
                      f"the tier copy of {key} freed")
            else:
                check(s3_code(lambda: c.get_object(
                    "tierremote", tier_key)) == "NoSuchKey",
                    f"the remote tier copy of {key} freed")
        # 4: Select over a CSV, JSON lines, a gzip CSV, an SSE-S3 CSV
        csv_in = "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"
        sources = {
            "csv": ("data.csv", csv_body, None, csv_in),
            "jsonl": ("data.jsonl", jsonl_body, None,
                      "<JSON><Type>LINES</Type></JSON>"),
            "gzip": ("data.csv.gz", gzip.compress(csv_body, 6, mtime=0),
                     None, "<CompressionType>GZIP</CompressionType>" +
                     csv_in),
            "sse": ("sse.csv", csv_body, SSE_S3, csv_in),
        }
        for key, data, hdrs, _ in sources.values():
            c.put_object("sel", key, data, headers=hdrs)
        queries = [(name, q) for name in ("csv", "jsonl", "gzip")
                   for q in ("where", "agg")] + [("sse", "where"),
                                                 ("degraded", "where")]
        seconds: dict = {}
        for name, q in queries:
            key, data, _, input_xml = sources[
                "csv" if name == "degraded" else name]
            if name == "degraded":
                er = layer.get_hashed_set(key)
                fi, _ = er._read_quorum_fileinfo("sel", key)
                for d, shard in enumerate(fi.erasure.distribution):
                    if shard <= M:
                        shutil.rmtree(f"{er.disks[d].endpoint()}/sel/{key}")
            payload = select_request(SEL_WHERE if q == "where" else SEL_AGG,
                                     input_xml)
            r, t = timed_step(steps, f"select {name} {q}", lambda: c.request(
                "POST", f"/sel/{key}", "select&select-type=2", payload))
            records, scanned = select_answer(r.body)
            rows = [ln.split(",") for ln in records.decode().splitlines()]
            if q == "where":
                got = [(int(i), float(a)) for i, a in rows]
                check(got == want_where, f"select {name} {q}: {len(got)} "
                      f"rows against {len(want_where)}")
            else:
                (count, total), = rows
                check(int(count) == want_count and abs(float(total) - want_sum)
                      <= SEL_SUM_RTOL * want_sum,
                      f"select {name} {q}: {count}, {total} against "
                      f"{want_count}, {want_sum}")
            seconds[f"{name}_{q}"] = {"s": t, "scanned": scanned,
                                      "mb_per_s": scanned / t / 1e6}
            if name == "csv" and q == "agg":
                # the layer read under the CSV Selects, timed alone
                reads = []
                for n in range(3):
                    (_, got), t = timed_step(
                        steps, f"layer read {n}",
                        lambda: layer.get_object("sel", key))
                    check(got == data, "the layer read of the CSV")
                    reads.append(t)
                readings["select_layer_read_s"] = reads
        readings["select"] = seconds
        torch.cuda.synchronize()
        launches = delta(s0, snapshot())
    finally:
        shutil.rmtree(tier_root, ignore_errors=True)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"tier and select path: {kernel} plain version ran")
    check(steps["transition"]["hh256"][0] > 0,
          "Kernel B not launched in the transitions")
    for key in bodies:
        for kernel in ("gf8_apply", "hh256"):
            check(steps[f"restore {key}"][kernel][0] > 0,
                  f"{kernel} not launched in the restore of {key}")
    for name, q in queries:
        check(steps[f"select {name} {q}"]["hh256"][0] > 0,
              f"Kernel B not launched in the select {name} {q}")
    check(steps["select degraded where"]["gf8_apply"][0] > 0,
          "Kernel A not launched in the degraded select")
    readings.update(
        phase_s=time.perf_counter() - t_phase,
        launches={step: {k: v[0] for k, v in got.items()}
                  for step, got in steps.items()})
    sel = readings["select"]
    print(f"tier and select path on {card}: transition of 3 x 16 MiB "
          f"{[round(t, 3) for t in readings['transition_s']]} s (crawler "
          f"cycle {readings['crawler_cycle_s']:.2f} s), restore "
          f"{[round(t, 3) for t in readings['restore_s']]} s; select "
          + ", ".join(f"{k} {v['s']:.2f} s {v['mb_per_s']:.2f} MB/s"
                      for k, v in sel.items())
          + f"; the CSV's layer read "
          f"{[round(t, 3) for t in readings['select_layer_read_s']]} s"
          + f"; phase {readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings


EV_BUCKET, EV_OBJ, EV_PART = "events", 16 << 20, 8 << 20           # phase 17
EV_PAIRS = 6
EV_ARN = "arn:minio:sqs::1:webhook"
# the reference's event names have no s3:ObjectRestore:* wildcard
EV_NAMES = ("s3:ObjectCreated:*", "s3:ObjectAccessed:*", "s3:ObjectRemoved:*",
            "s3:ObjectRestore:Post", "s3:ObjectRestore:Completed")


def notification_xml(arn: str, prefix: str) -> bytes:
    return (b'<NotificationConfiguration xmlns="http://s3.amazonaws.com/doc/'
            b'2006-03-01/"><QueueConfiguration><Queue>' + arn.encode() +
            b'</Queue>' + b"".join(b"<Event>%s</Event>" % n.encode()
                                   for n in EV_NAMES) +
            b"<Filter><S3Key><FilterRule><Name>prefix</Name><Value>" +
            prefix.encode() + b"</Value></FilterRule></S3Key></Filter>"
            b"</QueueConfiguration></NotificationConfiguration>")


class WebhookSink:
    """A local webhook endpoint: every POSTed record with its arrival
    time (perf_counter); ``stop`` and ``start`` take it down and bring it
    back on the same port."""

    def __init__(self):
        import threading
        self.records: list = []         # (arrival s, record)
        self._mu = threading.Lock()
        self.port = 0
        self.httpd = None
        self._thread = None

    def start(self) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                now = time.perf_counter()
                with sink._mu:
                    sink.records.extend((now, r) for r in
                                        json.loads(body)["Records"])
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self._thread.join()
            self.httpd = None

    def got(self) -> list:
        with self._mu:
            return list(self.records)


def listen_stream(srv, client, bucket: str, query: str, out: list):
    """A ListenNotification stream read line by line on a thread, each
    record with its arrival time (perf_counter) appended to ``out``;
    returns the thread once the server holds the subscription."""
    import http.client
    import threading
    from minio_tpu_torch.s3.sigv4 import sign_request
    url = client._url(f"/{bucket}", query)
    hdrs = sign_request(client._creds, "GET", url, {}, b"", client.region)
    subs = srv.events.pubsub.num_subscribers

    def run():
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
        try:
            conn.request("GET", url[len(srv.endpoint):], headers=hdrs)
            resp = conn.getresponse()
            out.append(("status", resp.status))
            while True:
                line = resp.readline()
                if not line:
                    break
                if line.strip():
                    out.append((time.perf_counter(),
                                json.loads(line)["Records"][0]))
        finally:
            conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while srv.events.pubsub.num_subscribers <= subs and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    check(srv.events.pubsub.num_subscribers > subs, "listener subscribed")
    return t


def wipe_data_shards(layer, bucket: str, key: str) -> None:
    """Remove ``key`` from the drives of its first M data shards."""
    er = layer.get_hashed_set(key)
    fi, _ = er._read_quorum_fileinfo(bucket, key)
    for d, shard in enumerate(fi.erasure.distribution):
        if shard <= M:
            shutil.rmtree(f"{er.disks[d].endpoint()}/{bucket}/{key}")


def phase_events(srv, card: str, gen):
    """Phase 17: the other bucket configs and event notification, on the
    running server of phases 14-16.  Returns the launches and the
    readings."""
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.s3.client import S3Client
    t_phase = time.perf_counter()
    c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
    layer = srv.layer
    blob = rand_bytes((5, EV_OBJ), gen).cpu().numpy()
    base, obj, mp, out1, out2 = (blob[i].tobytes() for i in range(5))
    small = blob[4][:64 * 1024].tobytes()
    readings: dict = {}
    steps: dict = {}
    qdir = tempfile.mkdtemp(prefix="chip-smoke-events-")
    sink = WebhookSink()
    try:
        # 1: the configs, against what the reference answers
        c.make_bucket("evplain")
        c.make_bucket(EV_BUCKET)
        c.set_bucket_versioning(EV_BUCKET, True)
        repl = (b'<ReplicationConfiguration><Rule><ID>r1</ID><Status>Enabled'
                b'</Status><Priority>1</Priority><Filter><Prefix>ev/</Prefix>'
                b'</Filter><Destination><Bucket>arn:minio:replication::t:dst'
                b'</Bucket></Destination></Rule></ReplicationConfiguration>')
        check(s3_code(lambda: c.request("PUT", "/evplain", "replication",
                                        repl)) == "InvalidRequest",
              "replication on an unversioned bucket")
        c.request("PUT", f"/{EV_BUCKET}", "replication", repl)
        got = c.request("GET", f"/{EV_BUCKET}", "replication").body
        check(b"<ID>r1</ID>" in got and b"<DeleteReplication><Status>"
              b"Disabled</Status>" in got, f"GET ?replication: {got[:200]}")
        check(c.request("DELETE", f"/{EV_BUCKET}", "replication").status
              == 204, "DELETE ?replication")
        check(s3_code(lambda: c.request("GET", f"/{EV_BUCKET}",
                                        "replication")) ==
              "ReplicationConfigurationNotFoundError", "replication gone")
        c.put_object(EV_BUCKET, "acl/k", small)
        for path in (f"/{EV_BUCKET}", f"/{EV_BUCKET}/acl/k"):
            check(b"<Permission>FULL_CONTROL</Permission>" in c.request(
                "GET", path, "acl").body, f"GET {path}?acl")
            c.request("PUT", path, "acl", headers={"x-amz-acl": "private"})
            check(s3_code(lambda: c.request(
                "PUT", path, "acl", headers={"x-amz-acl": "public-read"}))
                == "NotImplemented", f"PUT {path}?acl public-read")
        check(s3_code(lambda: c.request("GET", f"/{EV_BUCKET}", "cors")) ==
              "NoSuchCORSConfiguration", "GET ?cors")
        for sub, want in (("accelerate", b"<AccelerateConfiguration"),
                          ("requestPayment", b"<Payer>BucketOwner</Payer>"),
                          ("logging", b"<BucketLoggingStatus")):
            check(want in c.request("GET", f"/{EV_BUCKET}", sub).body,
                  f"GET ?{sub}")
        check(s3_code(lambda: c.request("GET", f"/{EV_BUCKET}", "website"))
              == "NoSuchWebsiteConfiguration", "GET ?website")
        # 2: without a notification config, the requests to compare with
        torch.cuda.synchronize()
        reset_counts()
        s0 = snapshot()
        _, t = timed_step(steps, "put_before", lambda: c.put_object(
            EV_BUCKET, "ev/base", base))
        readings["put_16mib_before_s"] = t
        r, t = timed_step(steps, "get_before", lambda: c.get_object(
            EV_BUCKET, "ev/base"))
        check(r.body == base, "GET before")
        readings["get_16mib_before_s"] = t
        wipe_data_shards(layer, EV_BUCKET, "ev/base")
        r, t = timed_step(steps, "degraded_get_before", lambda: c.get_object(
            EV_BUCKET, "ev/base"))
        check(r.body == base, "degraded GET before")
        readings["degraded_get_16mib_before_s"] = t
        # 3: the webhook target, the notification config, a listener
        sink.start()
        adm.set_config_kv("notify_webhook", "endpoint",
                          f"http://127.0.0.1:{sink.port}/hook")
        adm.set_config_kv("notify_webhook", "queue_dir", qdir)
        adm.set_config_kv("notify_webhook", "enable", "on")
        check(srv.events.valid_arns() == {EV_ARN}, "the webhook target")
        check(s3_code(lambda: c.request(
            "PUT", f"/{EV_BUCKET}", "notification",
            notification_xml("arn:minio:sqs::9:webhook", "ev/"))) ==
            "MalformedXML", "an unknown ARN refused")
        c.request("PUT", f"/{EV_BUCKET}", "notification",
                  notification_xml(EV_ARN, "ev/"))
        check(b"<Value>ev/</Value>" in c.request(
            "GET", f"/{EV_BUCKET}", "notification").body, "GET ?notification")
        heard: list = []
        listener = listen_stream(srv, c, EV_BUCKET,
                                 "events&timeout=120&max-events=9", heard)
        # 4: the requests, each answered at ``done[i]``
        done: list = []
        expect: list = []       # (event name, key, size, etag, version id)

        def step(name, fn, event, key, size, vid_of, etag_of=None):
            r, t = timed_step(steps, name, fn)
            done.append(time.perf_counter())
            expect.append((event, key, size, etag_of(r) if etag_of else
                           None, vid_of(r)))
            return r, t

        def vid(r):
            return r.headers.get("x-amz-version-id", "")

        def etag(r):
            return r.headers["ETag"].strip('"')

        r, t = step("put", lambda: c.put_object(EV_BUCKET, "ev/obj", obj),
                    "ObjectCreated:Put", "ev/obj", EV_OBJ, vid, etag)
        readings["put_16mib_s"] = t
        obj_etag, obj_vid = etag(r), vid(r)
        r, t = step("get", lambda: c.get_object(EV_BUCKET, "ev/obj"),
                    "ObjectAccessed:Get", "ev/obj", EV_OBJ, vid, etag)
        check(r.body == obj, "GET body")
        readings["get_16mib_s"] = t
        wipe_data_shards(layer, EV_BUCKET, "ev/obj")
        r, t = step("degraded_get", lambda: c.get_object(EV_BUCKET, "ev/obj"),
                    "ObjectAccessed:Get", "ev/obj", EV_OBJ, vid, etag)
        check(r.body == obj, "degraded GET body")
        readings["degraded_get_16mib_s"] = t

        def multipart():
            uid, parts, _ = c.upload_parts(EV_BUCKET, "ev/mp", mp, EV_PART, 2)
            return c.complete_multipart_upload(EV_BUCKET, "ev/mp", uid, parts)

        r, _ = step("multipart", multipart,
                    "ObjectCreated:CompleteMultipartUpload", "ev/mp", EV_OBJ,
                    vid, lambda r: r.xml().findtext(
                        "{http://s3.amazonaws.com/doc/2006-03-01/}ETag")
                    .strip('"'))
        r, _ = step("copy", lambda: c.copy_object(EV_BUCKET, "ev/copy",
                                                  EV_BUCKET, "ev/obj"),
                    "ObjectCreated:Copy", "ev/copy", EV_OBJ, vid,
                    lambda r: r.xml().findtext(
                        "{http://s3.amazonaws.com/doc/2006-03-01/}ETag")
                    .strip('"'))
        step("tag", lambda: c.put_object_tagging(EV_BUCKET, "ev/obj",
                                                 {"phase": "17"}, obj_vid),
             "ObjectCreated:PutTagging", "ev/obj", EV_OBJ,
             lambda r: obj_vid, lambda r: obj_etag)
        # a restore of the multipart object from phase 16's S3 tier
        info = layer.get_object_info(EV_BUCKET, "ev/mp")
        info.transition_tier = "REMOTE"
        srv.transition.transition(EV_BUCKET, info)
        r, t = step("restore", lambda: c.request(
            "POST", f"/{EV_BUCKET}/ev/mp", "restore",
            b"<RestoreRequest><Days>1</Days></RestoreRequest>", expect=(202,)),
            "ObjectRestore:Completed", "ev/mp", None,
            lambda r: info.version_id)
        readings["restore_16mib_s"] = t
        r, _ = step("delete", lambda: c.delete_object(EV_BUCKET, "ev/copy"),
                    "ObjectRemoved:DeleteMarkerCreated", "ev/copy", 0, vid,
                    lambda r: "")
        r, _ = step("outside", lambda: c.put_object(EV_BUCKET, "other/k",
                                                    small),
                    "ObjectCreated:Put", "other/k", len(small), vid, etag)
        listener.join(60)
        check(not listener.is_alive(), "the listen stream ended")
        torch.cuda.synchronize()
        s_deliver = snapshot()
        deadline = time.monotonic() + 30
        while len(sink.got()) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        torch.cuda.synchronize()
        steps["delivery"] = delta(s_deliver, snapshot())

        def same(rec, want) -> bool:
            o = rec["s3"]["object"]
            event, key, size, et, v = want
            return (rec["eventName"], o["key"], o["versionId"]) == \
                (event, key, v) and (size is None or o["size"] == size) and \
                (et is None or o["eTag"] == et)

        stream = [x for x in heard if x[0] != "status"]
        check(heard[0] == ("status", 200) and len(stream) == len(expect),
              f"the stream's records: {len(stream)} of {len(expect)}")
        for (_, rec), want in zip(stream, expect):
            check(same(rec, want), f"stream record {rec['eventName']} "
                  f"{rec['s3']['object']} against {want}")
        hooked = sink.got()
        want_hook = [(w, d) for w, d in zip(expect, done)
                     if w[1].startswith("ev/")]
        check(len(hooked) == len(want_hook),
              f"the sink's records: {len(hooked)} of {len(want_hook)}")
        for key in {w[1] for w, _ in want_hook}:
            got_k = [rec for _, rec in hooked
                     if rec["s3"]["object"]["key"] == key]
            want_k = [w for w, _ in want_hook if w[1] == key]
            check(len(got_k) == len(want_k) and all(
                same(g, w) for g, w in zip(got_k, want_k)),
                f"the sink's records of {key} in request order")
        delays = {"sink": [], "listener": []}
        pool = list(hooked)
        for w, d in want_hook:
            i = next(i for i, (_, rec) in enumerate(pool) if same(rec, w))
            delays["sink"].append(pool.pop(i)[0] - d)
        for (at, _), d in zip(stream, done):
            delays["listener"].append(at - d)
        readings["delay_s"] = {k: {"median": float(np.median(v)),
                                   "max": max(v), "all": v}
                               for k, v in delays.items()}
        # 5: the outage: the sink down, two PUTs stored, then replayed
        sink.stop()
        torch.cuda.synchronize()
        s_out = snapshot()
        c.put_object(EV_BUCKET, "ev/out1", out1)
        c.put_object(EV_BUCKET, "ev/out2", out2)
        torch.cuda.synchronize()
        steps["outage_puts"] = delta(s_out, snapshot())
        s_store = snapshot()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rows = json.loads(c.request(
                "GET", "/minio-tpu/admin/v1/targets").body)["targets"]
            if rows and rows[0]["stored"] == 2 and not rows[0]["online"]:
                break
            time.sleep(0.05)
        torch.cuda.synchronize()
        steps["storing"] = delta(s_store, snapshot())
        check(rows[0]["target"] == EV_ARN and not rows[0]["online"] and
              rows[0]["stored"] == 2, f"the target offline: {rows}")
        check(len(os.listdir(qdir)) == 2, f"queue_dir: {os.listdir(qdir)}")
        sink.start()
        before = len(sink.got())
        torch.cuda.synchronize()
        s_rep = snapshot()
        t0 = time.perf_counter()
        doc = json.loads(c.request(
            "POST", "/minio-tpu/admin/v1/targets/replay").body)
        readings["replay_s"] = time.perf_counter() - t0
        deadline = time.monotonic() + 30
        while len(sink.got()) < before + 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        torch.cuda.synchronize()
        steps["replay"] = delta(s_rep, snapshot())
        readings["replayed"] = doc["replayed"]
        check(sorted(rec["s3"]["object"]["key"] for _, rec in
                     sink.got()[before:]) == ["ev/out1", "ev/out2"],
              "the stored records replayed")
        check(os.listdir(qdir) == [], "queue_dir emptied")
        scrape = c.request("GET", "/minio-tpu/metrics", sign=False).body
        check(b'mt_target_sent_total{target="' + EV_ARN.encode() +
              b'",target_type="notify"} 10' in scrape and
              b"mt_target_online" in scrape, "mt_target_* in the scrape")
        # 6: the event's cost: a PUT and a GET of 16 MiB with the
        # notification config and without, in alternating pairs
        paired: dict = {"on": {"put": [], "get": []},
                        "off": {"put": [], "get": []}}
        for i in range(EV_PAIRS):
            for side in (("on", "off") if i % 2 else ("off", "on")):
                # an empty configuration removes the stored one
                c.request("PUT", f"/{EV_BUCKET}", "notification",
                          notification_xml(EV_ARN, "ev/") if side == "on"
                          else b"<NotificationConfiguration/>")
                key = f"ev/pair{i}{side}"
                _, t = timed_step(steps, f"pair_put_{side}{i}", lambda:
                                  c.put_object(EV_BUCKET, key, obj))
                paired[side]["put"].append(t)
                r, t = timed_step(steps, f"pair_get_{side}{i}", lambda:
                                  c.get_object(EV_BUCKET, key))
                check(r.body == obj, f"GET {key}")
                paired[side]["get"].append(t)
        readings["paired_s"] = paired
        deadline = time.monotonic() + 30
        while len(sink.got()) < before + 2 + 2 * EV_PAIRS and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        check(len(sink.got()) == before + 2 + 2 * EV_PAIRS,
              "the paired steps' records: one PUT and one GET per pair on")
        torch.cuda.synchronize()
        launches = delta(s0, snapshot())
        # the target goes before its queue_dir does
        adm.set_config_kv("notify_webhook", "enable", "off")
        check(EV_ARN not in srv.events.valid_arns(), "the webhook closed")
    finally:
        sink.stop()
        shutil.rmtree(qdir, ignore_errors=True)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"events path: {kernel} plain version ran")
    for name in ("put", "get", "degraded_get"):
        check(steps[name] == steps[f"{name}_before"],
              f"{name} launches {steps[name]} against "
              f"{steps[f'{name}_before']} without notification")
    for name in ("put", "degraded_get", "multipart", "copy", "restore",
                 "outage_puts"):
        for kernel in ("gf8_apply", "hh256"):
            check(steps[name][kernel][0] > 0,
                  f"{kernel} not launched in the {name} step")
    check(steps["get"]["hh256"][0] > 0, "Kernel B not launched in the GET")
    for name in ("tag", "delete", "delivery", "storing", "replay"):
        check(all(v == (0, 0) for v in steps[name].values()),
              f"the {name} step launched a kernel: {steps[name]}")
    for op in ("put", "get"):
        for i in range(EV_PAIRS):
            check(steps[f"pair_{op}_on{i}"] == steps[f"pair_{op}_off{i}"]
                  == steps[f"{op}_before"], f"pair {i}: {op} launches")
    readings.update(
        phase_s=time.perf_counter() - t_phase,
        launches={step: {k: v[0] for k, v in got.items()}
                  for step, got in steps.items()})
    d = readings["delay_s"]
    med = {side: {op: float(np.median(v)) for op, v in ops.items()}
           for side, ops in readings["paired_s"].items()}
    readings["paired_median_s"] = med
    print(f"events path on {card}: {EV_PAIRS} alternating pairs, median "
          f"16 MiB PUT {med['on']['put']:.4f} s with notification, "
          f"{med['off']['put']:.4f} s without, GET {med['on']['get']:.4f} / "
          f"{med['off']['get']:.4f} s; first 16 MiB PUT "
          f"{readings['put_16mib_s']:.3f} s "
          f"with notification, {readings['put_16mib_before_s']:.3f} s "
          f"without; GET {readings['get_16mib_s']:.3f} / "
          f"{readings['get_16mib_before_s']:.3f} s, degraded GET "
          f"{readings['degraded_get_16mib_s']:.3f} / "
          f"{readings['degraded_get_16mib_before_s']:.3f} s; delay to the "
          f"sink median {d['sink']['median'] * 1e3:.2f} ms max "
          f"{d['sink']['max'] * 1e3:.2f} ms, to the listener median "
          f"{d['listener']['median'] * 1e3:.2f} ms max "
          f"{d['listener']['max'] * 1e3:.2f} ms; replay of 2 "
          f"{readings['replay_s'] * 1e3:.2f} ms; phase "
          f"{readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings

REPL_SRC, REPL_DST = "replsrc", "repldst"                        # phase 18
REPL_OBJ, REPL_PART = 16 << 20, 8 << 20
REPL_LIMIT = REPL_OBJ // 2          # a REPL_OBJ task sleeps about 1 s
REPL_ARN = "arn:minio:replication::1:" + REPL_DST


def replication_xml(arn: str, prefix: str) -> bytes:
    return (b'<ReplicationConfiguration><Rule><ID>r1</ID><Status>Enabled'
            b'</Status><Priority>1</Priority><DeleteMarkerReplication>'
            b'<Status>Enabled</Status></DeleteMarkerReplication><Filter>'
            b'<Prefix>' + prefix.encode() + b'</Prefix></Filter>'
            b'<Destination><Bucket>' + arn.encode() + b'</Bucket>'
            b'</Destination></Rule></ReplicationConfiguration>')


def phase_replication(srv, card: str, gen):
    """Phase 18: bucket replication from the running server of phases
    14-17 to a second ``build_server`` (one set of 16 drives, 12 + 4),
    both in this process on the one card.  Returns the launches and the
    readings."""
    import threading
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.background.replication import STATUS_KEY
    from minio_tpu_torch.objectlayer.interface import ObjectOptions
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.server_main import build_server
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-repl-")
    dst = build_server([f"{root}/d{i}" for i in range(K + M)], "127.0.0.1:0",
                       S3_KEY, S3_SECRET, BLOCK, device="cuda")
    dst.start()
    dst_up = True
    c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    cd = S3Client(dst.endpoint, S3_KEY, S3_SECRET)
    adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
    blob = rand_bytes((10, REPL_OBJ), gen).cpu().numpy()
    objs = [blob[i].tobytes() for i in range(len(blob))]
    readings: dict = {}
    steps: dict = {}
    answered: dict = {}         # (key, version id) -> response time
    done: dict = {}             # (key, version id) -> task end time
    try:
        for client, b in ((c, REPL_SRC), (cd, REPL_DST), (cd, "repllocal")):
            client.make_bucket(b)
            client.set_bucket_versioning(b, True)
        torch.cuda.synchronize()
        reset_counts()
        s0 = snapshot()

        # 1: the target, then the rule, its ARN checked
        def registry():
            adm.set_remote_target(REPL_SRC, {
                "arn": REPL_ARN, "endpoint": dst.endpoint,
                "target_bucket": REPL_DST, "access_key": S3_KEY,
                "secret_key": S3_SECRET})
            return adm.list_remote_targets()
        listed, _ = timed_step(steps, "registry", registry)
        check(listed[REPL_SRC]["arn"] == REPL_ARN and
              listed[REPL_SRC]["endpoint"] == dst.endpoint,
              f"list-remote-targets: {listed}")
        repl = srv.replication
        check(repl is not None and len(repl._threads) == 2,
              "set-remote-target started two workers")
        check(s3_code(lambda: c.request(
            "PUT", f"/{REPL_SRC}", "replication",
            replication_xml("arn:minio:replication::1:nosuch", "in/"))) ==
            "ReplicationDestinationNotFoundError", "an unknown ARN refused")
        c.request("PUT", f"/{REPL_SRC}", "replication",
                  replication_xml(REPL_ARN, "in/"))
        # each task's end, for the seconds from a response to the stamp
        run_one = repl._replicate_one

        def timed_one(bucket, name, vid, delete):
            out = run_one(bucket, name, vid, delete)
            done[(name, vid)] = time.perf_counter()
            return out
        repl._replicate_one = timed_one

        def drained(fn):
            def run():
                out = fn()
                check(repl.drain(120), "replication drained")
                return out
            return run

        def put(key, data, headers=None):
            r = c.put_object(REPL_SRC, key, data, headers)
            answered[(key, r.headers["x-amz-version-id"])] = \
                time.perf_counter()
            return r

        # 2: the launches of what replication adds, each alone
        _, t = timed_step(steps, "put_alone", lambda: put(
            "out/alone", objs[0]))
        readings["put_alone_s"] = t
        r, _ = timed_step(steps, "get_alone", lambda: c.get_object(
            REPL_SRC, "out/alone"))
        check(r.body == objs[0], "GET out/alone")
        timed_step(steps, "dest_put_alone", lambda: cd.put_object(
            "repllocal", "k", objs[0]))
        # 3: the replicated writes
        _, t = timed_step(steps, "put", drained(lambda: put(
            "in/one", objs[1], {"x-amz-meta-phase": "18",
                                "Content-Type": "application/x-smoke"})))
        readings["put_replicated_s"] = t

        def multipart():
            uid, parts, _ = c.upload_parts(REPL_SRC, "in/mp", objs[2],
                                           REPL_PART, 2)
            r = c.complete_multipart_upload(REPL_SRC, "in/mp", uid, parts)
            answered[("in/mp", r.headers["x-amz-version-id"])] = \
                time.perf_counter()
        timed_step(steps, "multipart", drained(multipart))

        def copy():
            r = c.copy_object(REPL_SRC, "in/copy", REPL_SRC, "in/one")
            answered[("in/copy", r.headers["x-amz-version-id"])] = \
                time.perf_counter()
        timed_step(steps, "copy", drained(copy))
        timed_step(steps, "twice", drained(lambda: [
            put("in/twice", objs[3]), put("in/twice", objs[4])]))
        timed_step(steps, "delete", drained(lambda: c.delete_object(
            REPL_SRC, "in/copy")))
        timed_step(steps, "outside", drained(lambda: put(
            "out/skip", objs[5])))
        vid = srv.layer.get_object_info(REPL_SRC, "in/one").version_id
        timed_step(steps, "stamp", lambda: srv.layer.put_object_metadata(
            REPL_SRC, "in/one", vid, {STATUS_KEY: "COMPLETED"}))
        # 4: what arrived
        for key, want in (("in/one", objs[1]), ("in/mp", objs[2]),
                          ("in/twice", objs[4])):
            src_get, dst_get = (cl.get_object(b, key) for cl, b in (
                (c, REPL_SRC), (cd, REPL_DST)))
            check(src_get.body == want and dst_get.body == want,
                  f"the replica of {key}")
            for h, v in src_get.headers.items():
                if h.lower().startswith("x-amz-meta-") or h == \
                        "Content-Type":
                    check(dst_get.headers.get(h) == v,
                          f"{key}'s {h} on the replica")
        check(cd.get_object(REPL_DST, "in/one").headers.get(
            "x-amz-meta-phase") == "18", "metadata carried")
        dvers = cd.list_object_versions(REPL_DST, "in/twice")
        check([cd.get_object(REPL_DST, "in/twice", version_id=v[
            "version_id"]).body for v in dvers] == [objs[4], objs[3]],
            "both versions of in/twice, the newer latest")
        check([v["delete_marker"] for v in cd.list_object_versions(
            REPL_DST, "in/copy")] == [True, False], "the marker replicated")
        check(cd.list_objects(REPL_DST, "out/")["objects"] == [],
              "nothing outside the rule replicated")
        for v in c.list_object_versions(REPL_SRC, "in/"):
            if not v["delete_marker"]:
                ud = srv.layer.get_object_info(REPL_SRC, v["key"], (
                    ObjectOptions(version_id=v["version_id"]))).user_defined
                check(ud.get(STATUS_KEY) == "COMPLETED",
                      f"{v['key']} {v['version_id']}: {ud.get(STATUS_KEY)}")
        st = adm.replication_stats()
        check(st == {"queued": 6, "replicated": 5, "failed": 0,
                     "deletesReplicated": 1, "replicaBytes": 5 * REPL_OBJ},
              f"replication-stats {st}")
        # 5: an SSE-S3 object reaches the destination as its GET gives it
        _, t = timed_step(steps, "sse", drained(lambda: put(
            "in/sse", objs[6], SSE_S3)))
        check(srv.layer.get_object(REPL_SRC, "in/sse")[1] != objs[6],
              "stored encrypted")
        check(cd.get_object(REPL_DST, "in/sse").body == objs[6] ==
              c.get_object(REPL_SRC, "in/sse").body, "the SSE-S3 replica")
        readings["sse_put_replicated_s"] = t
        # 6: the bandwidth limit
        adm.set_bandwidth_limit(REPL_SRC, REPL_LIMIT)
        _, t = timed_step(steps, "throttled", drained(lambda: put(
            "in/slow", objs[7])))
        vid = srv.layer.get_object_info(REPL_SRC, "in/slow").version_id
        slow = done[("in/slow", vid)] - answered[("in/slow", vid)]
        readings["throttled_s"] = slow
        check(slow >= 0.9, f"throttled to {REPL_LIMIT} B/s: {slow:.3f} s")
        bw = adm.bandwidth()[REPL_SRC]
        check(bw == {"limitInBytesPerSecond": REPL_LIMIT,
                     "totalBytesMoved": 7 * REPL_OBJ}, f"bandwidth {bw}")
        adm.set_bandwidth_limit(REPL_SRC, 0)
        # 7: the destination down: the task fails, its version FAILED
        dst.stop()
        dst_up = False
        _, t = timed_step(steps, "failure", drained(lambda: put(
            "in/lost", objs[8])))
        vid = srv.layer.get_object_info(REPL_SRC, "in/lost").version_id
        ud = srv.layer.get_object_info(REPL_SRC, "in/lost", ObjectOptions(
            version_id=vid)).user_defined
        check(ud.get(STATUS_KEY) == "FAILED", f"in/lost: {ud.get(STATUS_KEY)}")
        check(adm.replication_stats()["failed"] == 1, "failed counted")
        # 8: the scrape and background-status
        scrape = parse_scrape(adm.metrics())
        for fam, want in (("mt_replication_objects_total", 7),
                          ("mt_replication_failed_total", 1),
                          ("mt_replication_deletes_total", 1),
                          ("mt_replication_pending", 0)):
            check(scrape.get((fam, ())) == want,
                  f"{fam} {scrape.get((fam, ()))}, want {want}")
        bg = json.loads(c.request(
            "GET", "/minio-tpu/admin/v1/background-status").body)
        check(bg["replication"]["stats"]["replicated"] == 7,
              f"background-status {bg['replication']}")
        torch.cuda.synchronize()
        launches = delta(s0, snapshot())
        check(not [t for t in threading.enumerate() if t.name.startswith(
            "mt-repl-worker-") and t not in repl._threads],
            "only the source's replication workers run")
    finally:
        if dst_up:
            dst.stop()
        shutil.rmtree(root, ignore_errors=True)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"replication path: {kernel} plain version ran")

    def plus(*names):
        return {k: tuple(sum(steps[n][k][i] for n in names) for i in (0, 1))
                for k in KERNELS}
    one = plus("put_alone", "get_alone", "dest_put_alone")
    for name in ("put", "throttled"):
        check(steps[name] == one, f"{name} launches {steps[name]}, want "
              f"the PUT's, the source read's and the destination PUT's "
              f"{one}")
    check(steps["twice"] == {k: (2 * v[0], 2 * v[1]) for k, v in one.items()},
          f"two PUTs of in/twice: {steps['twice']}")
    check(steps["outside"] == steps["put_alone"],
          f"a PUT outside the rule launched {steps['outside']}")
    check(steps["failure"] == plus("put_alone", "get_alone"),
          f"the failed task launched {steps['failure']}")
    for name in ("multipart", "copy", "sse"):
        for kernel in ("gf8_apply", "hh256"):
            check(steps[name][kernel][0] > 0,
                  f"{kernel} not launched in the {name} step")
    for name in ("registry", "delete", "stamp"):
        check(all(v == (0, 0) for v in steps[name].values()),
              f"the {name} step launched a kernel: {steps[name]}")
    lags = [done[k] - answered[k] for k in answered
            if k[0] not in ("in/slow", "in/lost") and k in done]
    readings.update(
        response_to_completed_s={"median": float(np.median(lags)),
                                 "max": max(lags), "all": lags},
        phase_s=time.perf_counter() - t_phase,
        launches={step: {k: v[0] for k, v in got.items()}
                  for step, got in steps.items()})
    lag = readings["response_to_completed_s"]
    print(f"replication path on {card}: a {REPL_OBJ / 2**20:g} MiB PUT "
          f"{readings['put_alone_s']:.3f} s alone, "
          f"{readings['put_replicated_s']:.3f} s with its replication "
          f"drained; from a response to its COMPLETED stamp median "
          f"{lag['median']:.3f} s, max {lag['max']:.3f} s over "
          f"{len(lags)} PUTs; throttled to {REPL_LIMIT / 2**20:g} MiB/s "
          f"{readings['throttled_s']:.3f} s; phase "
          f"{readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings


BR_BUCKET, BR_OBJ, BR_PAIRS = "brokers", 16 << 20, 6               # phase 19
BR_KINDS = ("amqp", "kafka", "mqtt", "nats", "nsq", "redis", "mysql",
            "postgresql", "elasticsearch")
BR_ARNS = {k: f"arn:minio:sqs::1:{k}" for k in BR_KINDS}
BR_NS_KEY = f"{BR_BUCKET}/br/obj"       # the namespace kinds' entry


def broker_stubs() -> dict:
    """kind -> stub class: the frame-parsing brokers of
    ``tests/broker_stubs.py``, which imports neither package but in its
    MySQL stub's session, where it checks the client's scramble with
    ``minio_tpu``'s function; the smoke's MySQL stub walks the same
    protocol and checks it with the port's."""
    import struct
    from minio_tpu_torch.events.sqlwire import mysql_native_scramble
    from tests import broker_stubs as bs

    class MySQLStub(bs.MySQLStubBroker):
        def _session(self, conn):
            recv_exact, _ = self._reader(conn)
            seq = [0]

            def send_pkt(payload):
                n = len(payload)
                conn.sendall(bytes([n & 255, (n >> 8) & 255,
                                    (n >> 16) & 255, seq[0]]) + payload)
                seq[0] = (seq[0] + 1) & 255

            def read_pkt():
                hdr = recv_exact(4)
                seq[0] = (hdr[3] + 1) & 255
                return recv_exact(hdr[0] | (hdr[1] << 8) | (hdr[2] << 16))

            def err(code, msg):
                send_pkt(b"\xff" + struct.pack("<H", code) + b"#42000" +
                         msg.encode())

            salt = bytes(b % 255 + 1 for b in os.urandom(20))   # no NUL
            send_pkt(b"\x0a8.0-stub\x00" + struct.pack("<I", 7) + salt[:8] +
                     b"\x00" + struct.pack("<H", 0xFFFF) + b"\x21" +
                     struct.pack("<HH", 2, 0xFFFF) + bytes([21]) +
                     b"\x00" * 10 + salt[8:] + b"\x00mysql_native_password"
                     b"\x00")
            resp = read_pkt()
            end = resp.index(b"\x00", 32)
            user = resp[32:end].decode()
            token = resp[end + 2:end + 2 + resp[end + 1]]
            if user != self.user or \
                    token != mysql_native_scramble(self.password, salt):
                self.auth_failures += 1
                err(1045, f"Access denied for user '{user}'")
                return
            send_pkt(b"\x00\x00\x00" + struct.pack("<HH", 2, 0))
            while True:
                pkt = read_pkt()
                if not pkt or pkt[0] == 0x01:          # COM_QUIT
                    return
                try:
                    tag = self.sql.apply(pkt[1:].decode())
                    n = 1 if tag.startswith(("INSERT", "DELETE 1")) else 0
                    send_pkt(b"\x00" + bytes([n]) + b"\x00" +
                             struct.pack("<HH", 2, 0))
                except ValueError as e:
                    err(1050 if "already exists" in str(e) else 1064, str(e))

    return {"amqp": bs.AMQPStubBroker, "kafka": bs.KafkaStubBroker,
            "mqtt": bs.MQTTStubBroker, "nats": bs.NATSStubBroker,
            "nsq": bs.NSQStubBroker, "redis": bs.RedisStubBroker,
            "mysql": MySQLStub, "postgresql": bs.PostgresStubBroker,
            "elasticsearch": bs.ESStubServer}


def broker_settings(kind: str, port: int, qdir: str) -> dict:
    """The ``notify_<kind>`` keys for a stub on ``port``: the namespace
    format for Redis, MySQL and PostgreSQL, the access format for
    Elasticsearch, MQTT at QoS 1, a ``queue_dir`` for each."""
    addr = f"127.0.0.1:{port}"
    return dict({
        "amqp": {"url": f"amqp://minio:secret@{addr}/", "exchange": "ev",
                 "routing_key": "bucketlogs"},
        "kafka": {"brokers": addr, "topic": "minio-events"},
        "mqtt": {"broker": f"tcp://{addr}", "topic": "minio/events",
                 "qos": "1"},
        "nats": {"address": addr, "subject": "bucketevents",
                 "username": "evuser", "password": "evpass"},
        "nsq": {"nsqd_address": addr, "topic": "minio"},
        "redis": {"address": addr, "key": "minio_events",
                  "format": "namespace"},
        "mysql": {"dsn_string": f"evuser:evpass@tcp({addr})/minio",
                  "table": "events_ns", "format": "namespace"},
        "postgresql": {"connection_string": f"host=127.0.0.1 port={port} "
                       "user=evuser password=evpass dbname=minio",
                       "table": "events_ns", "format": "namespace"},
        "elasticsearch": {"url": f"http://{addr}", "index": "minio-log",
                          "format": "access"},
    }[kind], queue_dir=qdir, enable="on")


def broker_count(kind: str, stub) -> int:
    """The records a stub holds so far (a keyed kind: its writes)."""
    if kind == "kafka":
        return len(stub.produced)
    if kind == "redis":
        return sum(c[0] in ("HSET", "HDEL") for c in stub.commands)
    if kind in ("mysql", "postgresql"):
        return sum(not s.startswith("CREATE") for s in stub.sql.statements)
    if kind == "elasticsearch":
        return sum(len(ix) for ix in stub.indices.values())
    return len(stub.published)


def broker_records(kind: str, stub) -> list:
    """The event records a message-per-event stub (or the access index)
    holds, in arrival order."""
    if kind == "amqp":
        bodies = [b for _, _, b, _ in stub.published]
    elif kind == "kafka":
        bodies = [v for _, _, v in stub.produced]
    elif kind == "mqtt":
        bodies = [p for _, p, _ in stub.published]
    elif kind == "elasticsearch":
        return [d["Records"][0] for d in stub.indices["minio-log"].values()]
    else:
        bodies = [p for _, p in stub.published]
    return [json.loads(b)["Records"][0] for b in bodies]


def broker_ops(kind: str, stub) -> list:
    """A namespace kind's writes in order: "set" or "del"."""
    if kind == "redis":
        return [{"HSET": "set", "HDEL": "del"}[c[0]] for c in stub.commands
                if c[0] in ("HSET", "HDEL")]
    return ["del" if s.startswith("DELETE") else "set"
            for s in stub.sql.statements if not s.startswith("CREATE")]


def broker_rows(kind: str, stub) -> dict:
    """A namespace kind's entries: {bucket/object: record}."""
    rows = stub.hashes.get("minio_events", {}) if kind == "redis" else \
        stub.sql.tables.get("events_ns", {})
    return {k: json.loads(v)["Records"][0] for k, v in rows.items()}


def stub_down(stub) -> None:
    """Stop a stub and wait until its port refuses: its accept thread,
    blocked on the closed socket, takes one more connection (this one)
    before it sees the stop."""
    import socket
    stub.stop()
    try:
        socket.create_connection(("127.0.0.1", stub.port), timeout=1).close()
    except OSError:
        pass
    stub._thread.join(5)
    check(not stub._thread.is_alive(), "the stub stopped")


def stub_up_on(cls, port: int):
    """A new stub of ``cls`` listening on ``port``."""
    import socket
    stub = cls()
    stub.sock.close()
    stub.sock = socket.socket()
    stub.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    stub.sock.bind(("127.0.0.1", port))
    stub.sock.listen(8)
    stub.port = port
    return stub.start()


def broker_notification_xml(prefix: str) -> bytes:
    return (b'<NotificationConfiguration xmlns="http://s3.amazonaws.com/doc/'
            b'2006-03-01/">' + b"".join(
                b"<QueueConfiguration><Id>%s</Id><Queue>%s</Queue>"
                b"<Event>s3:ObjectCreated:*</Event>"
                b"<Event>s3:ObjectAccessed:*</Event>"
                b"<Event>s3:ObjectRemoved:*</Event><Filter><S3Key><FilterRule>"
                b"<Name>prefix</Name><Value>%s</Value></FilterRule></S3Key>"
                b"</Filter></QueueConfiguration>" % (
                    k.encode(), arn.encode(), prefix.encode())
                for k, arn in BR_ARNS.items()) +
            b"</NotificationConfiguration>")


class StubWatch:
    """A thread that polls the stubs, from before a request on, until each
    kind's holds ``want[kind]`` records: ``seen[kind]`` is when it first
    saw them (perf_counter, at most one 0.5 ms poll late)."""

    def __init__(self, stubs: dict, want: dict, timeout: float = 30.0):
        import threading
        self.seen: dict = {}
        self._stubs, self._want = stubs, want
        self._deadline = time.monotonic() + timeout
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        pending = set(self._want)
        while pending and time.monotonic() < self._deadline:
            for kind in list(pending):
                if broker_count(kind, self._stubs[kind]) >= self._want[kind]:
                    self.seen[kind] = time.perf_counter()
                    pending.discard(kind)
            time.sleep(0.0005)

    def join(self) -> dict:
        self._thread.join()
        missing = sorted(set(self._want) - set(self.seen))
        check(not missing, "records missing at " + ", ".join(
            f"{k} ({broker_count(k, self._stubs[k])} of {self._want[k]})"
            for k in missing))
        return self.seen


def phase_brokers(srv, card: str, gen):
    """Phase 19: the nine broker targets, on the running server of phases
    14-18.  Returns the launches and the readings."""
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.s3.client import S3Client
    t_phase = time.perf_counter()
    c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
    adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
    layer = srv.layer
    blob = rand_bytes((5, BR_OBJ), gen).cpu().numpy()
    base, obj, obj2, out1, out2 = (blob[i].tobytes() for i in range(5))
    readings: dict = {}
    steps: dict = {}
    classes = broker_stubs()
    stubs: dict = {}
    qroot = tempfile.mkdtemp(prefix="chip-smoke-brokers-")
    try:
        # 1: without a broker target, the requests to compare with
        c.make_bucket(BR_BUCKET)
        torch.cuda.synchronize()
        reset_counts()
        s0 = snapshot()
        _, readings["put_16mib_before_s"] = timed_step(
            steps, "put_before", lambda: c.put_object(BR_BUCKET, "br/base",
                                                      base))
        r, readings["get_16mib_before_s"] = timed_step(
            steps, "get_before", lambda: c.get_object(BR_BUCKET, "br/base"))
        check(r.body == base, "GET before")
        wipe_data_shards(layer, BR_BUCKET, "br/base")
        r, readings["degraded_get_16mib_before_s"] = timed_step(
            steps, "degraded_get_before", lambda: c.get_object(
                BR_BUCKET, "br/base"))
        check(r.body == base, "degraded GET before")
        # 2: the nine stubs and the nine subsystems, through SetConfigKV
        for kind in BR_KINDS:
            stubs[kind] = classes[kind]().start()
        t0 = time.perf_counter()
        for kind in BR_KINDS:
            for key, value in broker_settings(
                    kind, stubs[kind].port, f"{qroot}/{kind}").items():
                adm.set_config_kv(f"notify_{kind}", key, value)
        readings["configure_s"] = time.perf_counter() - t0
        check(set(BR_ARNS.values()) <= srv.events.valid_arns(),
              f"the nine targets: {sorted(srv.events.valid_arns())}")
        # 3: the notification config, an unknown ARN refused first
        check(s3_code(lambda: c.request(
            "PUT", f"/{BR_BUCKET}", "notification",
            broker_notification_xml("br/").replace(b"::1:kafka",
                                                   b"::9:kafka")))
            == "MalformedXML", "an unknown ARN refused")
        c.request("PUT", f"/{BR_BUCKET}", "notification",
                  broker_notification_xml("br/"))
        # 4: the requests, each awaited at every stub before the next
        expect: list = []           # (event name, size, etag)
        delays: dict = {}
        rows_after_put: dict = {}

        def etag(r):
            return r.headers["ETag"].strip('"')

        def step(name, fn, event, size, etag_of):
            watch = StubWatch(stubs, {k: len(expect) + 1 for k in BR_KINDS})
            r, t = timed_step(steps, name, fn)
            done = time.perf_counter()
            expect.append((event, size, etag_of(r)))
            s = snapshot()
            for kind, at in watch.join().items():
                delays.setdefault(kind, {})[name] = at - done
            torch.cuda.synchronize()
            steps[f"delivery_{name}"] = delta(s, snapshot())
            return r, t

        r, readings["put_16mib_s"] = step(
            "put", lambda: c.put_object(BR_BUCKET, "br/obj", obj),
            "ObjectCreated:Put", BR_OBJ, etag)
        first_etag = etag(r)
        for kind in ("redis", "mysql", "postgresql"):
            rows_after_put[kind] = broker_rows(kind, stubs[kind])
        r, readings["get_16mib_s"] = step(
            "get", lambda: c.get_object(BR_BUCKET, "br/obj"),
            "ObjectAccessed:Get", BR_OBJ, etag)
        check(r.body == obj, "GET body")
        wipe_data_shards(layer, BR_BUCKET, "br/obj")
        r, readings["degraded_get_16mib_s"] = step(
            "degraded_get", lambda: c.get_object(BR_BUCKET, "br/obj"),
            "ObjectAccessed:Get", BR_OBJ, etag)
        check(r.body == obj, "degraded GET body")
        r, readings["put2_16mib_s"] = step(
            "put2", lambda: c.put_object(BR_BUCKET, "br/obj", obj2),
            "ObjectCreated:Put", BR_OBJ, etag)
        check(etag(r) != first_etag, "the second PUT's ETag")
        step("delete", lambda: c.delete_object(BR_BUCKET, "br/obj"),
             "ObjectRemoved:Delete", None, lambda r: None)
        timed_step(steps, "outside", lambda: c.put_object(
            BR_BUCKET, "other/k", out1[:64 * 1024]))
        for t in srv.egress.targets():
            if t.name in BR_ARNS.values():
                t.flush(30.0)

        def same(rec, want) -> bool:
            o = rec["s3"]["object"]
            event, size, et = want
            return (rec["eventName"], o["key"]) == (event, "br/obj") and \
                (size is None or o["size"] == size) and \
                (et is None or o["eTag"] == et)

        for kind in BR_KINDS:
            check(broker_count(kind, stubs[kind]) == len(expect),
                  f"{kind}: {broker_count(kind, stubs[kind])} records, "
                  f"want {len(expect)} (none for the key outside br/)")
            if kind in ("redis", "mysql", "postgresql"):
                rows = rows_after_put[kind]
                check(list(rows) == [BR_NS_KEY] and same(
                    rows[BR_NS_KEY], expect[0]), f"{kind}: the PUT's row")
                check(broker_ops(kind, stubs[kind]) == ["set"] * 4 + ["del"]
                      and broker_rows(kind, stubs[kind]) == {},
                      f"{kind}: four writes, then the DELETE removed the row")
                continue
            got = broker_records(kind, stubs[kind])
            check(len(got) == len(expect) and all(
                same(g, w) for g, w in zip(got, expect)),
                f"{kind}: the records in request order")
        check([q for _, _, q in stubs["mqtt"].published] == [1] * len(expect),
              "MQTT at QoS 1")
        # a GET's record comes before its 16 MiB body has left: the median
        # and the largest are the writes'
        writes = ("put", "put2", "delete")
        readings["delay_s"] = {
            k: {"median": float(np.median([v[n] for n in writes])),
                "max": max(v[n] for n in writes), "by_step": v}
            for k, v in delays.items()}
        # 5: the outage: the Kafka stub down, two PUTs stored, replayed
        kafka_port = stubs["kafka"].port
        stub_down(stubs["kafka"])
        _, readings["outage_puts_s"] = timed_step(
            steps, "outage_puts", lambda: (
                c.put_object(BR_BUCKET, "br/out1", out1),
                c.put_object(BR_BUCKET, "br/out2", out2)))
        torch.cuda.synchronize()
        s_store = snapshot()
        kafka_arn = BR_ARNS["kafka"]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rows = {r["target"]: r for r in json.loads(c.request(
                "GET", "/minio-tpu/admin/v1/targets").body)["targets"]}
            if rows[kafka_arn]["stored"] == 2 and \
                    not rows[kafka_arn]["online"]:
                break
            time.sleep(0.05)
        check(rows[kafka_arn]["stored"] == 2 and not
              rows[kafka_arn]["online"], f"Kafka offline: {rows[kafka_arn]}")
        check(len(os.listdir(f"{qroot}/kafka")) == 2,
              f"Kafka's queue_dir: {os.listdir(f'{qroot}/kafka')}")
        others = [k for k in BR_KINDS if k != "kafka"]
        StubWatch(stubs, {k: len(expect) + 2 for k in others}).join()
        torch.cuda.synchronize()
        steps["storing"] = delta(s_store, snapshot())
        stubs["kafka"] = stub_up_on(classes["kafka"], kafka_port)
        torch.cuda.synchronize()
        s_rep = snapshot()
        t0 = time.perf_counter()
        doc = json.loads(c.request(
            "POST", "/minio-tpu/admin/v1/targets/replay").body)
        readings["replay_s"] = time.perf_counter() - t0
        readings["replayed"] = doc["replayed"].get(f"notify/{kafka_arn}")
        StubWatch(stubs, {"kafka": 2}).join()
        torch.cuda.synchronize()
        steps["replay"] = delta(s_rep, snapshot())
        check([r["s3"]["object"]["key"] for r in
               broker_records("kafka", stubs["kafka"])] ==
              ["br/out1", "br/out2"], "the stored records replayed in order")
        check(os.listdir(f"{qroot}/kafka") == [], "queue_dir emptied")
        # 6: the scrape: every target's families, its deliveries counted
        scrape = parse_scrape(adm.metrics())
        for kind, arn in BR_ARNS.items():
            lab = (("target", arn), ("target_type", "notify"))
            check(scrape.get(("mt_target_sent_total", lab)) ==
                  len(expect) + 2 and scrape.get(("mt_target_online", lab))
                  == 1 and ("mt_target_store_length", lab) in scrape,
                  f"mt_target_* of {arn}")
        readings["delivery_mean_s"] = {
            kind: scrape[("mt_target_delivery_seconds_sum",
                          (("target", arn), ("target_type", "notify")))] /
            scrape[("mt_target_delivery_seconds_count",
                    (("target", arn), ("target_type", "notify")))]
            for kind, arn in BR_ARNS.items()}
        # 7: the cost of nine targets: a 16 MiB PUT and GET with the
        # notification config and without, in alternating pairs
        paired: dict = {"on": {"put": [], "get": []},
                        "off": {"put": [], "get": []}}
        for i in range(BR_PAIRS):
            for side in (("on", "off") if i % 2 else ("off", "on")):
                c.request("PUT", f"/{BR_BUCKET}", "notification",
                          broker_notification_xml("br/") if side == "on"
                          else b"<NotificationConfiguration/>")
                key = f"br/pair{i}{side}"
                _, t = timed_step(steps, f"pair_put_{side}{i}", lambda:
                                  c.put_object(BR_BUCKET, key, obj))
                paired[side]["put"].append(t)
                r, t = timed_step(steps, f"pair_get_{side}{i}", lambda:
                                  c.get_object(BR_BUCKET, key))
                check(r.body == obj, f"GET {key}")
                paired[side]["get"].append(t)
        readings["paired_s"] = paired
        StubWatch(stubs, {k: (2 if k == "kafka" else len(expect) + 2) +
                          2 * BR_PAIRS for k in BR_KINDS}, timeout=60.0).join()
        torch.cuda.synchronize()
        launches = delta(s0, snapshot())
    finally:
        for stub in stubs.values():
            stub.stop()
        shutil.rmtree(qroot, ignore_errors=True)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"brokers path: {kernel} plain version ran")
    for name in ("put", "get", "degraded_get", "put2"):
        want = steps["put_before" if name == "put2" else f"{name}_before"]
        check(steps[name] == want,
              f"{name} launches {steps[name]} against {want} without "
              f"broker targets")
    for kernel in ("gf8_apply", "hh256"):
        check(steps["outage_puts"][kernel][0] > 0,
              f"{kernel} not launched in the outage PUTs")
    for name in [n for n in steps if n.startswith("delivery_")] + [
            "delete", "storing", "replay"]:
        check(all(v == (0, 0) for v in steps[name].values()),
              f"the {name} step launched a kernel: {steps[name]}")
    for op in ("put", "get"):
        for i in range(BR_PAIRS):
            check(steps[f"pair_{op}_on{i}"] == steps[f"pair_{op}_off{i}"]
                  == steps[f"{op}_before"], f"pair {i}: {op} launches")
    med = {side: {op: float(np.median(v)) for op, v in ops.items()}
           for side, ops in readings["paired_s"].items()}
    readings.update(
        paired_median_s=med, phase_s=time.perf_counter() - t_phase,
        launches={step: {k: v[0] for k, v in got.items()}
                  for step, got in steps.items()})
    d = readings["delay_s"]
    print(f"brokers path on {card}: {BR_PAIRS} alternating pairs, median "
          f"16 MiB PUT {med['on']['put']:.4f} s with nine targets, "
          f"{med['off']['put']:.4f} s without, GET {med['on']['get']:.4f} / "
          f"{med['off']['get']:.4f} s; delay from a write's response to its "
          f"record, median (max) ms: " + ", ".join(
              f"{k} {d[k]['median'] * 1e3:.2f} ({d[k]['max'] * 1e3:.2f})"
              for k in BR_KINDS) +
          f"; replay of 2 {readings['replay_s'] * 1e3:.2f} ms; phase "
          f"{readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings


FED_OBJ = 16 << 20                                   # phase 20
FED_REPS, FED_PAIRS = 5, 4
FED_BASE = "dc=example,dc=org"
FED_USERS, FED_GROUPS = f"ou=users,{FED_BASE}", f"ou=groups,{FED_BASE}"
FED_READERS = f"cn=readers,{FED_GROUPS}"
FED_ISSUER, FED_CLIENT = "https://idp.example.test", "minio-tpu-app"
FED_HS_SECRET = "oidc-shared-secret"
FED_OPA_TIMEOUT_S, FED_OPA_ATTEMPTS = 0.5, 2


def fed_directory() -> dict:
    """The directory of ``tests/ldap_stub.py``'s ``standard_directory``:
    DN -> {attribute: [values]}, passwords in ``userPassword``."""
    def user(uid, pw):
        return {"uid": [uid], "userPassword": [pw], "objectClass": ["person"]}
    return {
        f"cn=lookup,{FED_BASE}": {"userPassword": ["lookup-secret"]},
        f"uid=svc-alice,{FED_USERS}": user("svc-alice", "alice-pass"),
        f"uid=svc-bob,{FED_USERS}": user("svc-bob", "bob-pass"),
        FED_READERS: {"objectClass": ["groupOfNames"], "member": [
            f"uid=svc-alice,{FED_USERS}", f"uid=svc-bob,{FED_USERS}"]},
        f"cn=admins,{FED_GROUPS}": {"objectClass": ["groupOfNames"],
                                    "member": [f"uid=svc-alice,{FED_USERS}"]}}


def ldap_stub(directory: dict):
    """A directory server for simple bind and search (equality, presence,
    and, or, not) on a free local port, speaking BER through the port's
    codec; (server, thread, "host:port")."""
    import socketserver
    import threading
    from minio_tpu_torch.iam import ldap as L

    def tlvs(content):
        r, out = L.BERReader(content), []
        while not r.eof():
            out.append(r.read_tlv())
        return out

    def match(filt, attrs) -> bool:
        tag, content = filt
        if tag == L.FILTER_AND:
            return all(match(f, attrs) for f in tlvs(content))
        if tag == L.FILTER_OR:
            return any(match(f, attrs) for f in tlvs(content))
        if tag == L.FILTER_NOT:
            return not match(tlvs(content)[0], attrs)
        if tag == L.FILTER_PRESENT:
            return content.decode() in attrs
        (_, attr), (_, value) = tlvs(content)
        return value.decode() in attrs.get(attr.decode(), [])

    def answer(mid, op):
        return L.ber(L.SEQUENCE, L.ber_int(mid) + op)

    def result(tag, code):
        return L.ber(tag, L.ber_int(code, L.ENUMERATED) + L.ber_str("")
                     + L.ber_str(""))

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            f = self.request.makefile("rb")
            while True:
                head = f.read(2)
                if len(head) < 2:
                    return
                n = head[1]
                if n & 0x80:
                    n = int.from_bytes(f.read(n & 0x7F), "big")
                (_, mid), (op, body) = tlvs(f.read(n))
                mid = L.decode_int(mid)
                if op == L.APP_BIND_REQUEST:
                    _, (_, dn), (_, pw) = tlvs(body)
                    ok = pw.decode() in directory.get(
                        dn.decode(), {}).get("userPassword", [])
                    self.request.sendall(answer(mid, result(
                        L.APP_BIND_RESPONSE, 0 if ok else 49)))
                elif op == L.APP_SEARCH_REQUEST:
                    parts = tlvs(body)
                    base, filt = parts[0][1].decode(), parts[6]
                    out = []
                    for dn, attrs in directory.items():
                        if not dn.endswith(base) or not match(filt, attrs):
                            continue
                        battrs = b"".join(
                            L.ber(L.SEQUENCE, L.ber_str(k) + L.ber(
                                L.SET, b"".join(L.ber_str(v) for v in vs)))
                            for k, vs in attrs.items() if k != "userPassword")
                        out.append(answer(mid, L.ber(
                            L.APP_SEARCH_ENTRY,
                            L.ber_str(dn) + L.ber(L.SEQUENCE, battrs))))
                    # one write: a second small one would wait for the
                    # client's delayed ACK (Nagle)
                    self.request.sendall(b"".join(out) + answer(
                        mid, result(L.APP_SEARCH_DONE, 0)))
                else:                       # unbind, or what is not served
                    return

    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, name="smoke-ldap-stub")
    t.start()
    host, port = srv.server_address
    return srv, t, f"{host}:{port}"


def opa_stub():
    """An OPA webhook on a free local port that allows only
    ``s3:GetObject``; (server, thread, URL).  ``server.posts`` counts the
    decisions asked."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            doc = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            self.server.posts += 1
            body = json.dumps({"result": doc["input"]["action"] ==
                               "s3:GetObject"}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    srv.posts = 0
    t = threading.Thread(target=srv.serve_forever, name="smoke-opa-stub")
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_address[1]}/v1/data/allow"


def stop_stub(srv, t) -> None:
    srv.shutdown()
    srv.server_close()
    t.join(10)
    check(not t.is_alive(), "a stub's thread did not stop")


def probable_prime(bits: int) -> int:
    """A random ``bits``-bit prime from ``secrets``: 40 Miller-Rabin rounds
    with random bases."""
    import secrets
    small = [p for p in range(3, 2000, 2)
             if all(p % q for q in range(3, int(p ** 0.5) + 1, 2))]
    while True:
        n = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if any(n % p == 0 for p in small):
            continue
        d, r = n - 1, 0
        while d % 2 == 0:
            d, r = d // 2, r + 1
        for _ in range(40):
            x = pow(secrets.randbelow(n - 3) + 2, d, n)
            if x in (1, n - 1):
                continue
            for _ in range(r - 1):
                x = pow(x, 2, n)
                if x == n - 1:
                    break
            else:
                break
        else:
            return n


def rsa_keypair(bits: int = 2048) -> tuple:
    """(n, e, d) with e = 65537."""
    e = 65537
    while True:
        p, q = probable_prime(bits // 2), probable_prime(bits // 2)
        phi = (p - 1) * (q - 1)
        if p != q and phi % e and (p * q).bit_length() == bits:
            return p * q, e, pow(e, -1, phi)


def b64url(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def jwt(claims: dict, key=None) -> str:
    """An HS256 JWT under the shared secret, or with ``key`` = (n, e, d)
    an RS256 one (RSASSA-PKCS1-v1_5 with SHA-256, kid ``k1``)."""
    import hmac
    from minio_tpu_torch.iam.openid import SHA256_DIGEST_INFO
    head = {"alg": "RS256", "kid": "k1"} if key else {"alg": "HS256"}
    h = b64url(json.dumps({**head, "typ": "JWT"}).encode())
    c = b64url(json.dumps(claims).encode())
    msg = f"{h}.{c}".encode()
    if key is None:
        sig = hmac.new(FED_HS_SECRET.encode(), msg, hashlib.sha256).digest()
    else:
        n, _, d = key
        k = (n.bit_length() + 7) // 8
        t = SHA256_DIGEST_INFO + hashlib.sha256(msg).digest()
        em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
        sig = pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")
    return f"{h}.{c}.{b64url(sig)}"


def sts_refusal(client, form: dict) -> tuple:
    """(status, error code) of an unsigned STS form POST."""
    import re
    import urllib.parse
    r = client.request("POST", "/", body=urllib.parse.urlencode(
        form).encode(), headers={
            "Content-Type": "application/x-www-form-urlencoded"},
        sign=False, expect=())
    m = re.search(rb"<Code>([^<]*)</Code>", r.body)
    return r.status, m and m.group(1).decode()


def phase_federation(card: str, gen):
    """Phase 20 on a fresh ``build_server`` of 16 drives: IAM on etcd, LDAP
    and OpenID sessions with their federated 16 MiB PUT, GET and degraded
    GET held to the root credential's launches, and the OPA webhook armed
    live.  Returns the launches and the readings."""
    import statistics
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.server_main import build_server
    from tests.etcd_stub import StubEtcd
    t_phase = time.perf_counter()
    readings: dict = {}
    root = tempfile.mkdtemp(prefix="chip-smoke-fed-")
    dirs = [f"{root}/d{i}" for i in range(K + M)]
    key = rsa_keypair()
    n_len = (key[0].bit_length() + 7) // 8
    jwks = {"keys": [{"kty": "RSA", "kid": "k1", "alg": "RS256",
                      "n": b64url(key[0].to_bytes(n_len, "big")),
                      "e": b64url(key[1].to_bytes(3, "big"))}]}
    etcd = StubEtcd()
    etcd_ep = etcd.start()
    ldap_srv, ldap_t, ldap_addr = ldap_stub(fed_directory())
    opa_srv, opa_t, opa_url = opa_stub()
    opa_up = True
    env = {"MT_IDENTITY_LDAP_SERVER_ADDR": ldap_addr,
           "MT_IDENTITY_LDAP_LOOKUP_BIND_DN": f"cn=lookup,{FED_BASE}",
           "MT_IDENTITY_LDAP_LOOKUP_BIND_PASSWORD": "lookup-secret",
           "MT_IDENTITY_LDAP_USER_DN_SEARCH_BASE_DN": FED_USERS,
           "MT_IDENTITY_LDAP_USER_DN_SEARCH_FILTER": "(uid=%s)",
           "MT_IDENTITY_LDAP_GROUP_SEARCH_FILTER":
               "(&(objectClass=groupOfNames)(member=%d))",
           "MT_IDENTITY_LDAP_GROUP_SEARCH_BASE_DN": FED_GROUPS,
           "MT_IDENTITY_OPENID_ENABLE": "on",
           "MT_IDENTITY_OPENID_ISSUER": FED_ISSUER,
           "MT_IDENTITY_OPENID_CLIENT_ID": FED_CLIENT,
           "MT_IDENTITY_OPENID_HS256_SECRET": FED_HS_SECRET,
           "MT_IDENTITY_OPENID_JWKS": json.dumps(jwks),
           "MT_ETCD_ENDPOINTS": etcd_ep}

    def build(names):
        os.environ.update({k: env[k] for k in names})
        try:
            return build_server(dirs, "127.0.0.1:0", S3_KEY, S3_SECRET, BLOCK,
                                device="cuda")
        finally:
            for k in names:
                os.environ.pop(k, None)
    srv = srv2 = None
    try:
        srv = build(env)
        check(srv.ldap is not None and srv.openid is not None and
              srv.etcd is not None and srv.layer.sets[0].device.type ==
              "cuda", "the identities' server")
        srv.start()
        root_c = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        adm = AdminClient(srv.endpoint, S3_KEY, S3_SECRET)
        anon = S3Client(srv.endpoint, "", "")
        root_c.make_bucket("fed")
        body = rand_bytes((FED_OBJ,), gen).cpu().numpy().tobytes()
        torch.cuda.synchronize()
        reset_counts()
        s0 = snapshot()
        # 1: IAM on etcd
        t0 = time.perf_counter()
        adm.add_policy("fed-rw", {"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Action": ["s3:*"],
            "Resource": ["arn:aws:s3:::fed", "arn:aws:s3:::fed/*"]}]})
        readings["etcd_policy_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        adm.add_user("eve", "eve-secret-key", ["fed-rw"])
        readings["etcd_mutation_s"] = time.perf_counter() - t0
        check(b"config/iam/users/eve" in etcd.kv and
              b"config/iam/policies/fed-rw" in etcd.kv,
              f"IAM keys in etcd: {sorted(etcd.kv)}")
        check(not any(os.path.exists(f"{d}/.mt.sys/config/iam.json")
                      for d in dirs), "iam.json written beside etcd")
        eve = S3Client(srv.endpoint, "eve", "eve-secret-key")
        eve.put_object("fed", "eve/big", body)
        # 2: LDAP
        adm.set_user_policy(FED_READERS, ["readwrite"])
        check(FED_READERS.encode() in etcd.kv.get(
            b"config/iam/ldap-policies.json", b""), "the LDAP mapping in etcd")
        times = []
        for _ in range(FED_REPS):
            t0 = time.perf_counter()
            ldap_c = anon.assume_role_with_ldap_identity("svc-alice",
                                                         "alice-pass")
            times.append(time.perf_counter() - t0)
        readings["ldap_sts_ms"] = [t * 1e3 for t in times]
        steps = {}
        for who, c in (("root", root_c), ("ldap", ldap_c)):
            torch.cuda.synchronize()
            a = snapshot()
            c.put_object("fed", f"{who}/obj", body)
            torch.cuda.synchronize()
            b = snapshot()
            check(c.get_object("fed", f"{who}/obj").body == body,
                  f"{who} GET byte-exact")
            torch.cuda.synchronize()
            g = snapshot()
            wipe_data_shards(srv.layer, "fed", f"{who}/obj")
            check(c.get_object("fed", f"{who}/obj").body == body,
                  f"{who} degraded GET byte-exact")
            torch.cuda.synchronize()
            steps[who] = {"put": delta(a, b), "get": delta(b, g),
                          "degraded_get": delta(g, snapshot())}
        for step in ("put", "get", "degraded_get"):
            for kernel in ("gf8_apply", "hh256"):
                check(steps["ldap"][step][kernel] ==
                      steps["root"][step][kernel],
                      f"LDAP {step} launches {steps['ldap'][step]} against "
                      f"root's {steps['root'][step]}")
            check(steps["root"][step]["hh256"][0] > 0,
                  f"hh256 not launched in the {step} step")
        check(steps["root"]["put"]["gf8_apply"][0] > 0 and
              steps["root"]["degraded_get"]["gf8_apply"][0] > 0,
              f"gf8_apply not launched: {steps['root']}")
        a = snapshot()
        got = sts_refusal(anon, {"Action": "AssumeRoleWithLDAPIdentity",
                                 "LDAPUsername": "svc-alice",
                                 "LDAPPassword": "wrong"})
        check(got == (400, "InvalidParameterValue") and
              delta(a, snapshot()) == {k: (0, 0) for k in KERNELS},
              f"a wrong LDAP password answered {got}")
        # 3: OpenID
        now = int(time.time())
        claims = {"iss": FED_ISSUER, "aud": FED_CLIENT, "sub": "user-42",
                  "exp": now + 600, "policy": "readonly"}
        times = []
        for i in range(FED_REPS):
            tok = jwt(claims, key if i % 2 else None)
            t0 = time.perf_counter()
            web_c = anon.assume_role_with_web_identity(tok)
            times.append(time.perf_counter() - t0)
            check(web_c.get_object("fed", "eve/big").body == body,
                  f"web identity GET ({'RS256' if i % 2 else 'HS256'})")
        readings["web_identity_sts_ms"] = [t * 1e3 for t in times]
        rs = jwt(claims, key)
        flipped = rs[:-6] + ("A" if rs[-6] != "A" else "B") + rs[-5:]
        for what, tok in (("expired", jwt({**claims, "exp": now - 10})),
                          ("wrong aud", jwt({**claims, "aud": "other"})),
                          ("flipped signature", flipped)):
            got = sts_refusal(anon, {"Action": "AssumeRoleWithWebIdentity",
                                     "WebIdentityToken": tok})
            check(got == (403, "AccessDenied"), f"{what} token: {got}")
        # 4: OPA
        def verdicts():
            return by_label(parse_scrape(adm.metrics()),
                            "mt_policy_webhook_total", "verdict")
        v0 = verdicts()
        adm.set_config_kv("policy_opa", "timeout",
                          f"{int(FED_OPA_TIMEOUT_S * 1000)}ms")
        adm.set_config_kv("policy_opa", "retry_attempts",
                          str(FED_OPA_ATTEMPTS))
        adm.set_config_kv("policy_opa", "url", opa_url)
        check(srv.iam.authorizer is not None, "the webhook armed")
        check(eve.get_object("fed", "eve/big").body == body,
              "GET allowed by the webhook")
        torch.cuda.synchronize()
        a = snapshot()
        r = eve.request("PUT", "/fed/eve/denied", body=body, expect=())
        torch.cuda.synchronize()
        check(r.status == 403 and r.xml().findtext("Code") ==
              "AccessDenied" and delta(a, snapshot()) ==
              {k: (0, 0) for k in KERNELS},
              f"the PUT the webhook denies answered {r.status}")
        posts = opa_srv.posts
        root_c.put_object("fed", "root/small", body[:4096])
        check(opa_srv.posts == posts, "root was sent to the webhook")
        pairs = {"opa": [], "local": []}
        for i in range(FED_PAIRS):
            for mode in (("opa", "local") if i % 2 == 0 else
                         ("local", "opa")):
                adm.set_config_kv("policy_opa", "url",
                                  opa_url if mode == "opa" else "")
                t0 = time.perf_counter()
                check(eve.get_object("fed", "eve/big").body == body,
                      f"GET ({mode})")
                pairs[mode].append(time.perf_counter() - t0)
        readings["get_16mib_opa_s"] = pairs["opa"]
        readings["get_16mib_local_s"] = pairs["local"]
        adm.set_config_kv("policy_opa", "url", opa_url)
        stop_stub(opa_srv, opa_t)
        opa_up = False
        t0 = time.perf_counter()
        r = eve.request("GET", "/fed/eve/big", expect=())
        readings["opa_down_deny_s"] = time.perf_counter() - t0
        check(r.status == 403 and readings["opa_down_deny_s"] <
              FED_OPA_TIMEOUT_S * FED_OPA_ATTEMPTS,
              f"with the webhook down: {r.status} after "
              f"{readings['opa_down_deny_s']:.3f} s")
        v1 = verdicts()
        got = {k: v1.get(k, 0) - v0.get(k, 0) for k in
               ("allow", "deny", "error")}
        want = {"allow": 1 + FED_PAIRS, "deny": 1, "error": 1}
        check(got == want, f"mt_policy_webhook_total {got}, want {want}")
        adm.set_config_kv("policy_opa", "url", "")
        check(srv.iam.authorizer is None and eve.put_object(
            "fed", "eve/after", body[:4096]).status == 200,
            "local policy back")
        srv.stop()
        # 5: a second server on the same drives and etcd
        srv2 = build(["MT_ETCD_ENDPOINTS"])
        srv2.start()
        check(S3Client(srv2.endpoint, "eve", "eve-secret-key").get_object(
            "fed", "eve/big").body == body, "eve after the restart")
        torch.cuda.synchronize()
        s_end = snapshot()
    finally:
        for s in (srv, srv2):
            if s is not None:
                s.stop()
        if opa_up:
            stop_stub(opa_srv, opa_t)
        stop_stub(ldap_srv, ldap_t)
        etcd.stop()
        etcd._thread.join(10)
        shutil.rmtree(root, ignore_errors=True)
    launches = delta(s0, s_end)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"identities path: {kernel} plain version ran")
    readings.update(
        phase_s=time.perf_counter() - t_phase,
        launches={f"{who}_{step}": {k: v[0] for k, v in got.items()}
                  for who, by in steps.items() for step, got in by.items()})
    med = statistics.median
    print(f"identities path on {card}: LDAP STS median "
          f"{med(readings['ldap_sts_ms']):.2f} ms, web-identity STS median "
          f"{med(readings['web_identity_sts_ms']):.2f} ms; 16 MiB GET with "
          f"OPA median {med(pairs['opa']):.4f} s, without "
          f"{med(pairs['local']):.4f} s ({FED_PAIRS} alternating pairs); "
          f"etcd-persisted add-user {readings['etcd_mutation_s']:.4f} s; "
          f"phase {readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings


CL_NODES, CL_PER = 4, 4                               # phase 21
CL_OBJ, CL_BIG, CL_OBJS = 16 << 20, 256 << 20, 4
CL_REPS, CL_PINGS = 3, 50
CL_SECRET = "smoke-cluster-secret"
CL_BOOT_S, CL_HEAL_S = 180.0, 120.0


def free_ports(n: int) -> list:
    """Free ports below the ephemeral range: a node restarted on its ports
    finds them free, whatever connections the phase opened meanwhile."""
    import random
    import socket
    rng = random.Random(os.getpid())
    ports: list = []
    while len(ports) < n:
        port = rng.randrange(20000, 32000)
        with socket.socket() as sk:
            try:
                sk.bind(("127.0.0.1", port))
            except OSError:
                continue
        if port not in ports:
            ports.append(port)
    return ports


def node_scrape(port: int, ctx=None) -> dict:
    """A node's parsed scrape, over ``https`` when given an SSL context."""
    import urllib.request
    scheme = "https" if ctx is not None else "http"
    with urllib.request.urlopen(
            f"{scheme}://127.0.0.1:{port}/minio-tpu/metrics", timeout=30,
            context=ctx) as r:
        return parse_scrape(r.read().decode())


def node_launches(port: int, ctx=None) -> dict:
    """A node process's {kernel: (launches, plain runs)} from its scrape
    (``mt_tpu_kernel_launches_total``; zeros before its first launch)."""
    samples = node_scrape(port, ctx)
    out = {k: [0, 0] for k in KERNELS}
    for (name, labels), v in samples.items():
        if name == "mt_tpu_kernel_launches_total":
            lab = dict(labels)
            out[lab["kernel"]][lab["engine"] == "plain"] = int(v)
    return {k: tuple(v) for k, v in out.items()}


def node_part_files(dirs: list, bucket: str) -> dict:
    """{(drive, path): bytes} of every part.1 under ``bucket``."""
    out = {}
    for d in dirs:
        for base, _, files in os.walk(f"{d}/{bucket}"):
            for f in files:
                if f == "part.1":
                    with open(f"{base}/{f}", "rb") as fh:
                        out[(d, os.path.relpath(f"{base}/{f}", d))] = \
                            fh.read()
    return out


def holds_data_shard(dirs: list, bucket: str, key: str) -> bool:
    """Whether a drive of ``dirs`` holds one of ``key``'s data shards."""
    from minio_tpu_torch.storage.xl_meta import XLMeta
    for d in dirs:
        with open(f"{d}/{bucket}/{key}/xl.meta", "rb") as fh:
            fi = XLMeta.load(fh.read()).to_fileinfo(bucket, key, None)
        if fi.erasure.index <= K:
            return True
    return False


def phase_cluster(card: str, gen):
    """Phase 21: four node processes over one set of 16 drives on the
    card.  Returns the launches (the node processes' and this process's
    comparison server's) and the readings."""
    import statistics
    import threading
    from minio_tpu_torch.admin.client import AdminClient
    from minio_tpu_torch.parallel.rpc import RPCClient
    from minio_tpu_torch.s3.client import S3Client, S3ClientError
    from minio_tpu_torch.server_main import build_server
    t_phase = time.perf_counter()
    readings: dict = {}
    root = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    ids = [f"n{i + 1}" for i in range(CL_NODES)]
    ports = free_ports(2 * CL_NODES)
    rpc, s3 = ports[:CL_NODES], ports[CL_NODES:]
    dirs = {nid: [f"{root}/{nid}/d{j}" for j in range(CL_PER)]
            for nid in ids}
    peers = [f"{nid}=127.0.0.1:{rpc[i]}={','.join(dirs[nid])}"
             for i, nid in enumerate(ids)]
    env = dict(os.environ, MT_CLUSTER_SECRET=CL_SECRET,
               MT_ROOT_USER=S3_KEY, MT_ROOT_PASSWORD=S3_SECRET,
               MT_HEAL_INTERVAL_S=str(24 * 3600))
    repo = os.path.dirname(os.path.abspath(__file__))
    procs: dict = {}

    def start(nid: str) -> None:
        i = ids.index(nid)
        with open(f"{root}/{nid}.log", "ab") as log:
            procs[nid] = subprocess.Popen(
                [sys.executable, "-m", "minio_tpu_torch", "node",
                 "--node-id", nid, "--device", "cuda",
                 "--address", f"127.0.0.1:{s3[i]}", *peers],
                cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)

    def log_tail(nid: str) -> str:
        with open(f"{root}/{nid}.log", "rb") as fh:
            return fh.read()[-2000:].decode(errors="replace")

    def wait(nid: str) -> None:
        import urllib.request
        deadline = time.monotonic() + CL_BOOT_S
        while True:
            check(procs[nid].poll() is None,
                  f"node {nid} exited: {log_tail(nid)}")
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{s3[ids.index(nid)]}/minio/health/"
                    "live", timeout=5).close()
                return
            except OSError:
                check(time.monotonic() < deadline,
                      f"node {nid} never served: {log_tail(nid)}")
                time.sleep(0.2)

    def client(nid: str, key=S3_KEY, secret=S3_SECRET) -> S3Client:
        return S3Client(f"http://127.0.0.1:{s3[ids.index(nid)]}", key,
                        secret)

    def served(nid: str, fn) -> dict:
        """{kernel: (launches, plain)} that ``fn`` made ``nid`` run."""
        port = s3[ids.index(nid)]
        a = node_launches(port)
        fn()
        return delta(a, node_launches(port))

    def local(fn) -> dict:
        torch.cuda.synchronize()
        a = snapshot()
        fn()
        torch.cuda.synchronize()
        return delta(a, snapshot())

    srv = None
    s_begin = s_end = None
    node_totals: dict = {}
    try:
        t0 = time.perf_counter()
        for nid in ids:
            start(nid)
        for nid in ids:
            wait(nid)
        readings["boot_s"] = time.perf_counter() - t0
        bodies = {f"o{i}": rand_bytes((CL_OBJ,), gen).cpu().numpy().tobytes()
                  for i in range(CL_OBJS)}
        big = rand_bytes((CL_BIG,), gen).cpu().numpy().tobytes()
        c1, c2, c3 = client("n1"), client("n2"), client("n3")
        c1.make_bucket("clu")
        # the same requests on one process's set of 16 drives
        srv = build_server([f"{root}/single/d{i}" for i in range(K + M)],
                           "127.0.0.1:0", S3_KEY, S3_SECRET, BLOCK,
                           device="cuda")
        srv.start()
        cs = S3Client(srv.endpoint, S3_KEY, S3_SECRET)
        cs.make_bucket("clu")
        torch.cuda.synchronize()
        reset_counts()
        s_begin = snapshot()
        want, got = {}, {}
        want["put"] = local(lambda: cs.put_object("clu", "o0", bodies["o0"]))
        want["get"] = local(lambda: check(
            cs.get_object("clu", "o0").body == bodies["o0"], "single GET"))
        got["put"] = served("n1", lambda: c1.put_object("clu", "o0",
                                                        bodies["o0"]))
        got["get"] = served("n3", lambda: check(
            c3.get_object("clu", "o0").body == bodies["o0"],
            "cluster GET of o0"))
        for name, body in bodies.items():
            if name != "o0":
                c1.put_object("clu", name, body)
        puts, gets = [], []
        for rep in range(CL_REPS):
            # the first rep's launches, read outside its time
            a = node_launches(s3[0])
            t0 = time.perf_counter()
            c1.put_object_chunked("clu", "big", big, chunk_size=1 << 20)
            puts.append(time.perf_counter() - t0)
            if not rep:
                got["put_big"] = delta(a, node_launches(s3[0]))
            a = node_launches(s3[2])
            t0 = time.perf_counter()
            check(c3.get_object("clu", "big").body == big, "256 MiB GET")
            gets.append(time.perf_counter() - t0)
            if not rep:
                got["get_big"] = delta(a, node_launches(s3[2]))
        readings["put_256mib_s"], readings["get_256mib_s"] = puts, gets
        for name, body in bodies.items():
            check(c3.get_object("clu", name).body == body,
                  f"GET {name} through node 3")
        # locks: two PUTs of one key at once through two nodes
        racers = {"a": bodies["o1"], "b": bodies["o2"]}
        errs = []

        def race(c, body):
            try:
                c.put_object("clu", "raced", body)
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(e)
        threads = [threading.Thread(target=race, args=(c, b))
                   for c, b in ((c1, racers["a"]), (c2, racers["b"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(not errs, f"a raced PUT failed: {errs}")
        seen = {client(nid).get_object("clu", "raced").body for nid in ids}
        check(len(seen) == 1 and seen <= set(racers.values()),
              "the raced key is not one whole version on every node")
        # peers: a user and a bucket policy through node 1, a GET through 2
        user = client("n2", "peer-user", "peer-user-secret")
        r = user.request("GET", "/clu/o3", expect=())
        check(r.status == 403, f"the unknown user's GET answered {r.status}")
        adm = AdminClient(c1.endpoint, S3_KEY, S3_SECRET)
        t0 = time.perf_counter()
        adm.add_user("peer-user", "peer-user-secret", [])
        c1.set_bucket_policy("clu", {"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Principal": {"AWS": ["*"]},
            "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::clu/*"]}]})
        while True:
            try:
                check(user.get_object("clu", "o3").body == bodies["o3"],
                      "the peer's GET")
                break
            except S3ClientError:
                check(time.perf_counter() - t0 < 5.0,
                      "node 2 never took node 1's user and policy")
                time.sleep(0.01)
        readings["peer_change_s"] = time.perf_counter() - t0
        # node loss
        victim = next((n for n in bodies
                       if holds_data_shard(dirs["n4"], "clu", n)), None)
        check(victim is not None, "node 4 holds no data shard")
        held = node_part_files(dirs["n4"], "clu")
        check(len(held) >= CL_OBJS * CL_PER, f"node 4 holds {len(held)} parts")
        procs["n4"].kill()
        procs.pop("n4").wait(timeout=60)
        t0 = time.perf_counter()
        got["degraded_get"] = served("n2", lambda: check(
            c2.get_object("clu", victim).body == bodies[victim],
            "degraded GET through node 2"))
        readings["degraded_get_16mib_s"] = time.perf_counter() - t0
        for name, body in {**bodies, "big": big}.items():
            check(c2.get_object("clu", name).body == body,
                  f"GET {name} without node 4")
        wipe_data_shards(srv.layer, "clu", "o0")
        want["degraded_get"] = local(lambda: check(
            cs.get_object("clu", "o0").body == bodies["o0"],
            "single degraded GET"))
        srv.stop()
        srv = None
        torch.cuda.synchronize()
        s_end = snapshot()
        for step in want:
            check(got[step] == want[step],
                  f"cluster {step} launched {got[step]}, one process "
                  f"{want[step]}")
        check(got["degraded_get"]["gf8_apply"][0] > 0,
              "the degraded GET launched no Kernel A")
        # node 4 back on wiped drives: healed by its own start
        for d in dirs["n4"]:
            shutil.rmtree(d)
        t0 = time.perf_counter()
        start("n4")
        wait("n4")
        readings["reboot_s"] = time.perf_counter() - t0
        t_heal = time.perf_counter()
        while node_part_files(dirs["n4"], "clu") != held:
            check(time.perf_counter() - t_heal < CL_HEAL_S,
                  "node 4's part files never came back byte for byte")
            time.sleep(0.1)
        readings["heal_s"] = time.perf_counter() - t_heal
        check(client("n4").get_object("clu", victim).body == bodies[victim],
              "GET through the healed node")
        pinger = RPCClient(f"http://127.0.0.1:{rpc[0]}", CL_SECRET)
        pings = []
        for _ in range(CL_PINGS):
            t0 = time.perf_counter()
            check(pinger.call("sys", "ping") == "pong", "RPC ping")
            pings.append((time.perf_counter() - t0) * 1e3)
        pinger.close()
        readings["rpc_ping_ms"] = pings
        node_totals = {nid: node_launches(s3[ids.index(nid)])
                       for nid in ids}
        readings["launches_by_step"] = {
            step: {k: v[0] for k, v in by.items()}
            for step, by in got.items()}
    finally:
        if srv is not None:
            srv.stop()
        for nid, p in procs.items():
            p.terminate()
        for nid, p in procs.items():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
    launches = delta(s_begin, s_end)
    for nid, by in node_totals.items():
        for k, (n, plain) in by.items():
            check(plain == 0, f"node {nid}: {k} plain version ran")
            launches[k] = (launches[k][0] + n, launches[k][1] + plain)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"cluster path: {kernel} plain version ran")
    med = statistics.median
    readings["phase_s"] = time.perf_counter() - t_phase
    gib = CL_BIG / 2 ** 30
    readings["put_256mib_gibps"] = gib / med(puts)
    readings["get_256mib_gibps"] = gib / med(gets)
    print(f"cluster path on {card}: 4 nodes x 4 drives, 256 MiB PUT "
          f"{readings['put_256mib_gibps']:.3f} GiB/s, GET "
          f"{readings['get_256mib_gibps']:.3f} GiB/s (median of {CL_REPS}); "
          f"16 MiB degraded GET {readings['degraded_get_16mib_s']:.3f} s; "
          f"heal {readings['heal_s']:.2f} s; RPC ping median "
          f"{med(pings):.3f} ms; node boot {readings['boot_s']:.1f} s; "
          f"phase {readings['phase_s']:.1f} s")
    return {k: v[0] for k, v in launches.items()}, readings


TL_SECRET = "smoke-tls-secret"                        # phase 22
TL_REPS, TL_SHAKES = 2, 20
TL_FAULT_AT = 128 << 20         # the chaos PUT's bytes read before the cut
TL_HOLE_TIMEOUT_S, TL_HOLE_BOUND_S = 1.0, 5.0
TL_HEAL_S = 60.0


def tls_pki(root: str):
    """A CA, an S3 leaf and an internode leaf minted with the port's
    ``secure/pki.py`` (the system ``openssl``), laid out as a
    ``certs_dir``: (pki, certs dir)."""
    from minio_tpu_torch.secure import pki as port_pki
    check(port_pki.available(), f"{port_pki.OPENSSL} is missing: the phase "
          "cannot mint its PKI")
    pki = port_pki.mint_cluster_pki(f"{root}/pki")
    return pki, pki.write_certs_dir(f"{root}/certs")


def phase_tls_cluster(card: str, gen, cluster: dict):
    """Phase 22: phase 21's four node processes with both planes under
    TLS, the RPC plane's chaos drills on an in-process cluster behind
    fault proxies, and two federated fronts.  ``cluster``: phase 21's
    readings (its launches per request and its timings).  Returns the
    launches (the node processes' and this process's) and the
    readings."""
    import io
    import socket
    import ssl
    import statistics
    from minio_tpu_torch.cluster import Node, NodeSpec
    from minio_tpu_torch.objectlayer.healing import heal_object
    from minio_tpu_torch.parallel import dsync
    from minio_tpu_torch.parallel import rpc as port_rpc
    from minio_tpu_torch.parallel.faulty import Fault, FaultyProxy
    from minio_tpu_torch.s3.client import S3Client, S3ClientError
    from minio_tpu_torch.secure import pki as port_pki
    from minio_tpu_torch.secure import transport
    from minio_tpu_torch.secure.certs import CertManager
    from minio_tpu_torch.server_main import build_server
    from minio_tpu_torch.utils.retry import RetryPolicy
    t_phase = time.perf_counter()
    readings: dict = {"openssl": port_pki.OPENSSL,
                      "openssl_present": port_pki.available()}
    print(f"phase 22: {port_pki.OPENSSL} "
          f"{'present' if readings['openssl_present'] else 'missing'}",
          flush=True)
    root = tempfile.mkdtemp(prefix="chip-smoke-tls-")
    prior_manager = transport.manager()
    ids = [f"n{i + 1}" for i in range(CL_NODES)]
    ports = free_ports(2 * CL_NODES)
    rpc, s3 = ports[:CL_NODES], ports[CL_NODES:]
    dirs = {nid: [f"{root}/{nid}/d{j}" for j in range(CL_PER)]
            for nid in ids}
    peers = [f"{nid}=127.0.0.1:{rpc[i]}={','.join(dirs[nid])}"
             for i, nid in enumerate(ids)]
    repo = os.path.dirname(os.path.abspath(__file__))
    procs: dict = {}
    nodes: list = []
    proxies: list = []
    fronts: list = []
    saved_env: dict = {}

    def set_env(**kv) -> None:
        for k, v in kv.items():
            saved_env.setdefault(k, os.environ.get(k))
            os.environ[k] = v

    def log_tail(nid: str) -> str:
        with open(f"{root}/{nid}.log", "rb") as fh:
            return fh.read()[-2000:].decode(errors="replace")

    node_totals: dict = {}
    s_begin = s_end = None
    try:
        t0 = time.perf_counter()
        pki, certs = tls_pki(root)
        readings["mint_s"] = time.perf_counter() - t0
        mgr = CertManager.from_dir(certs)
        transport.configure(mgr)
        ca = ssl.create_default_context(cafile=pki.ca_cert)
        env = dict(os.environ, MT_CLUSTER_SECRET=TL_SECRET,
                   MT_ROOT_USER=S3_KEY, MT_ROOT_PASSWORD=S3_SECRET,
                   MT_HEAL_INTERVAL_S=str(24 * 3600), MT_TLS_ENABLE="on",
                   MT_TLS_CERTS_DIR=certs)

        def client(nid: str) -> S3Client:
            return S3Client(f"https://127.0.0.1:{s3[ids.index(nid)]}",
                            S3_KEY, S3_SECRET, ca_file=pki.ca_cert)

        def served(nid: str, fn) -> dict:
            port = s3[ids.index(nid)]
            a = node_launches(port, ca)
            fn()
            return delta(a, node_launches(port, ca))

        # -- four TLS node processes ----------------------------------------
        t0 = time.perf_counter()
        for i, nid in enumerate(ids):
            with open(f"{root}/{nid}.log", "ab") as log:
                procs[nid] = subprocess.Popen(
                    [sys.executable, "-m", "minio_tpu_torch", "node",
                     "--node-id", nid, "--device", "cuda",
                     "--address", f"127.0.0.1:{s3[i]}", *peers],
                    cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)
        for nid in ids:
            c = client(nid)
            c.timeout = 5.0
            deadline = time.monotonic() + CL_BOOT_S
            while True:
                check(procs[nid].poll() is None,
                      f"TLS node {nid} exited: {log_tail(nid)}")
                try:
                    c.request("GET", "/minio/health/live", sign=False,
                              expect=(200,))
                    break
                except OSError:
                    check(time.monotonic() < deadline,
                          f"TLS node {nid} never served: {log_tail(nid)}")
                    time.sleep(0.2)
        readings["boot_s"] = time.perf_counter() - t0
        with open(f"{root}/n1.log") as fh:
            check(f"rpc=https://127.0.0.1:{rpc[0]} " in fh.read(),
                  "node 1 does not serve its RPC over https")
        small = rand_bytes((CL_OBJ,), gen).cpu().numpy().tobytes()
        big = rand_bytes((CL_BIG,), gen).cpu().numpy().tobytes()
        c1, c3 = client("n1"), client("n3")
        c1.make_bucket("tls")
        got: dict = {}
        got["put"] = served("n1", lambda: c1.put_object("tls", "o0", small))
        got["get"] = served("n3", lambda: check(
            c3.get_object("tls", "o0").body == small, "TLS GET of 16 MiB"))
        puts, gets = [], []
        for rep in range(TL_REPS):
            # the first rep's launches, read outside its time
            a = node_launches(s3[0], ca)
            t0 = time.perf_counter()
            c1.put_object_chunked("tls", "big", big, chunk_size=1 << 20)
            puts.append(time.perf_counter() - t0)
            if not rep:
                got["put_big"] = delta(a, node_launches(s3[0], ca))
            a = node_launches(s3[2], ca)
            t0 = time.perf_counter()
            check(c3.get_object("tls", "big").body == big,
                  "TLS GET of 256 MiB")
            gets.append(time.perf_counter() - t0)
            if not rep:
                got["get_big"] = delta(a, node_launches(s3[2], ca))
        gib = CL_BIG / 2 ** 30
        readings["put_256mib_s"], readings["get_256mib_s"] = puts, gets
        readings["put_256mib_gibps"] = gib / statistics.median(puts)
        readings["get_256mib_gibps"] = gib / statistics.median(gets)
        want = cluster["launches_by_step"]
        for step, by in got.items():
            for k in ("gf8_apply", "hh256"):
                check(by[k][0] == want[step][k],
                      f"TLS cluster {step}: {k} launched {by[k][0]}, phase "
                      f"21 {want[step][k]}")
            check(all(p == 0 for _, p in by.values()),
                  f"TLS cluster {step}: a plain version ran")
        readings["launches_by_step"] = {
            step: {k: v[0] for k, v in by.items()}
            for step, by in got.items()}
        # the RPC port refuses a client without the internode identity
        fail_key = ("mt_tls_handshake_failed_total",
                    (("plane", "internode"),))
        before = node_scrape(s3[1], ca).get(fail_key, 0.0)
        with socket.create_connection(("127.0.0.1", rpc[1]),
                                      timeout=10) as raw:
            try:
                with ca.wrap_socket(raw, server_hostname="127.0.0.1") as sk:
                    sk.sendall(b"POST /rpc/sys/ping HTTP/1.1\r\n"
                               b"Content-Length: 0\r\n\r\n")
                    answered = sk.recv(1)
            except (ssl.SSLError, OSError):
                answered = b""
        check(answered == b"", "node 2's RPC port answered a client "
              "without a certificate")
        deadline = time.monotonic() + 10
        while node_scrape(s3[1], ca).get(fail_key, 0.0) < before + 1:
            check(time.monotonic() < deadline,
                  "node 2 did not count the refused handshake")
            time.sleep(0.05)
        # the internode identity's handshakes and pings
        inter = mgr.client_context("internode")
        shakes = []
        for _ in range(TL_SHAKES):
            with socket.create_connection(("127.0.0.1", rpc[0]),
                                          timeout=10) as raw:
                t = time.perf_counter()
                with inter.wrap_socket(raw, server_hostname="127.0.0.1"):
                    shakes.append((time.perf_counter() - t) * 1e3)
        readings["handshake_ms"] = shakes
        pinger = port_rpc.RPCClient(f"https://127.0.0.1:{rpc[0]}", TL_SECRET)
        pings = []
        try:
            for _ in range(CL_PINGS):
                t = time.perf_counter()
                check(pinger.call("sys", "ping") == "pong", "mTLS RPC ping")
                pings.append((time.perf_counter() - t) * 1e3)
        finally:
            pinger.close()
        readings["rpc_ping_ms"] = pings
        for nid in ids:
            sc = node_scrape(s3[ids.index(nid)], ca)
            check(sc.get(("mt_tls_handshake_total",
                          (("plane", "internode"),)), 0) > 0,
                  f"node {nid}'s scrape has no internode handshakes")
            check({dict(lab).get("cert") for n, lab in sc
                   if n == "mt_tls_cert_expiry_seconds"} ==
                  {"s3", "internode"},
                  f"node {nid}'s scrape lacks the certificate expiries")
        node_totals = {nid: node_launches(s3[ids.index(nid)], ca)
                       for nid in ids}
        for nid, p in procs.items():
            p.terminate()
        for nid, p in procs.items():
            p.wait(timeout=60)
        procs.clear()

        # -- chaos: an in-process cluster behind fault proxies ----------------
        set_env(MT_RPC_BREAKER_FAILURES="2", MT_RPC_BREAKER_COOLDOWN="200ms",
                MT_RPC_RETRY_ATTEMPTS="1")
        torch.cuda.synchronize()
        reset_counts()
        s_begin = snapshot()
        t0 = time.perf_counter()
        specs = [NodeSpec(f"c{i + 1}", [f"{root}/c{i + 1}/d{j}"
                                        for j in range(CL_PER)])
                 for i in range(CL_NODES)]
        for sp in specs:
            for d in sp.drive_dirs:
                os.makedirs(d)
        # boot every node, advertise a proxy in front of each RPC port,
        # then assemble over the proxied endpoints
        for sp in specs:
            nodes.append(Node(sp, specs, TL_SECRET, K + M, tls=mgr,
                              parity=M, block_size=BLOCK, device="cuda"))
        for sp in specs:
            proxy = FaultyProxy("127.0.0.1", int(sp.endpoint.rsplit(":", 1)[1]))
            proxies.append(proxy.start())
            sp.endpoint = f"https://127.0.0.1:{proxy.port}"
        for node in nodes:
            node.assemble()
        readings["chaos_boot_s"] = time.perf_counter() - t0
        layer = nodes[0].layer
        layer.make_bucket("chaos")
        p4 = proxies[3]

        class CutReader(io.BytesIO):
            """Reset node 4's link once the PUT has read TL_FAULT_AT."""
            cut = False

            def read(self, n=-1):
                chunk = super().read(n)
                if not self.cut and self.tell() >= TL_FAULT_AT:
                    self.cut = True
                    p4.set_default(Fault.reset(after_bytes=0))
                    p4.sever()
                return chunk
        reader = CutReader(big)
        t0 = time.perf_counter()
        layer.put_object("chaos", "cut", reader)
        readings["chaos_put_s"] = time.perf_counter() - t0
        check(reader.cut, "the chaos PUT never reached its fault")
        er = layer.get_hashed_set("cut")
        fis, _ = er._fanout(lambda d: d.read_version("chaos", "cut", None),
                            er.disks)
        check(sum(f is not None for f in fis) == K,
              f"the chaos PUT committed on {sum(f is not None for f in fis)}"
              f" drives, not {K}")
        # node 4's drives behind the resetting link: each RPC client's
        # breaker opens within two failures, and then calls fail fast
        from minio_tpu_torch.storage.errors import StorageError
        n4 = [d.inner for d in er.disks
              if d.endpoint().startswith(specs[3].endpoint + "/")]
        check(len(n4) == CL_PER, f"{len(n4)} drives behind node 4's proxy")
        for d in n4:
            for _ in range(2):
                try:
                    d.read_all("chaos-probe-vol", "nope")
                    check(False, "a drive behind a resetting link answered")
                except StorageError:
                    pass
        check(all(d._c.breaker.state == d._c.breaker.OPEN for d in n4),
              "node 4's breakers did not open")
        t0 = time.perf_counter()
        for d in n4:
            try:
                d.read_all("chaos-probe-vol", "nope")
            except StorageError:
                pass
        readings["fail_fast_ms"] = (time.perf_counter() - t0) * 1e3
        p4.set_default(Fault.passthrough())
        t0 = time.perf_counter()
        a = snapshot()
        while True:
            time.sleep(0.25)           # the cooldown, then the probe
            r = heal_object(er, "chaos", "cut")
            if r.after_ok == K + M:
                break
            check(time.perf_counter() - t0 < TL_HEAL_S,
                  f"node 4 never healed: {r}")
        readings["chaos_heal_s"] = time.perf_counter() - t0
        healed = delta(a, snapshot())
        check(healed["gf8_apply"][0] > 0, "the heal launched no Kernel A")
        readings["heal_launches"] = {k: v[0] for k, v in healed.items()}
        check(len([f for f in node_part_files(specs[3].drive_dirs, "chaos")
                   if "cut/" in f[1]]) == CL_PER,
              "node 4's drives do not hold the healed part files")
        verified = heal_object(er, "chaos", "cut", deep=True, dry_run=True)
        check(verified.before_ok == K + M,
              f"the healed shards do not verify: {verified}")
        check(nodes[1].layer.get_object("chaos", "cut")[1] == big,
              "GET of the healed object")
        p4.set_default(Fault.blackhole())
        p4.sever()
        hole = port_rpc.RPCClient(specs[3].endpoint, TL_SECRET,
                                  timeout=TL_HOLE_TIMEOUT_S,
                                  retry=RetryPolicy(attempts=1))
        t0 = time.perf_counter()
        try:
            hole.call("sys", "ping")
            check(False, "a black-holed RPC answered")
        except port_rpc.RPCError:
            pass
        finally:
            hole.close()
        readings["blackhole_s"] = time.perf_counter() - t0
        check(readings["blackhole_s"] < TL_HOLE_BOUND_S,
              f"the black-holed call took {readings['blackhole_s']:.2f} s")
        wait_heal_kicks()
        for node in nodes:
            node.stop()
        nodes.clear()
        for proxy in proxies:
            proxy.stop()
        proxies.clear()

        # -- federation: two fronts on one DNS file ----------------------------
        set_env(MT_FEDERATION_ENABLE="on",
                MT_FEDERATION_DOMAIN="fed.smoke.test",
                MT_FEDERATION_DNS_FILE=f"{root}/dns.json")
        for tag in ("fa", "fb"):
            fronts.append(build_server([f"{root}/{tag}/d{i}"
                                        for i in range(4)], "127.0.0.1:0",
                                       S3_KEY, S3_SECRET, BLOCK,
                                       device="cuda"))
            fronts[-1].start()
        fa, fb = (S3Client(f.endpoint, S3_KEY, S3_SECRET) for f in fronts)
        fa.make_bucket("fedb")
        try:
            fb.make_bucket("fedb")
            check(False, "front B made front A's bucket")
        except S3ClientError as e:
            check(e.code == "BucketAlreadyExists",
                  f"front B answered {e.code}")
        fa.put_object("fedb", "obj", small)
        r = fb.request("GET", "/fedb/obj", expect=(307,))
        loc = r.headers["Location"]
        check(loc == f"{fronts[0].endpoint}/fedb/obj",
              f"the redirect names {loc}")
        check(S3Client(loc.rsplit("/fedb/", 1)[0], S3_KEY, S3_SECRET)
              .get_object("fedb", "obj").body == small,
              "the followed redirect's body")
        fa.delete_object("fedb", "obj")
        fa.request("DELETE", "/fedb", expect=(204,))
        fb.make_bucket("fedb")
        check(fronts[1].federation.store.get("fedb").port == fronts[1].port,
              "DELETE bucket did not free the name")
        for f in fronts:
            f.stop()
        fronts.clear()
        torch.cuda.synchronize()
        s_end = snapshot()
    finally:
        for f in fronts:
            f.stop()
        for node in nodes:
            node.stop()
        for proxy in proxies:
            proxy.stop()
        for nid, p in procs.items():
            p.terminate()
        for nid, p in procs.items():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        transport.configure(prior_manager)
        # the cluster's locks started the shared refresher
        dsync.stop_refresher()
        shutil.rmtree(root, ignore_errors=True)
    launches = delta(s_begin, s_end)
    for nid, by in node_totals.items():
        for k, (n, plain) in by.items():
            check(plain == 0, f"TLS node {nid}: {k} plain version ran")
            launches[k] = (launches[k][0] + n, launches[k][1] + plain)
    for kernel, (_, plain) in launches.items():
        check(plain == 0, f"TLS cluster path: {kernel} plain version ran")
    med = statistics.median
    readings["phase_s"] = time.perf_counter() - t_phase
    print(f"TLS cluster path on {card}: 4 nodes x 4 drives over mTLS, "
          f"256 MiB PUT {readings['put_256mib_gibps']:.3f} GiB/s, GET "
          f"{readings['get_256mib_gibps']:.3f} GiB/s (median of {TL_REPS}; "
          f"phase 21: "
          f"{cluster['put_256mib_gibps']:.3f}, "
          f"{cluster['get_256mib_gibps']:.3f}); RPC ping median "
          f"{med(readings['rpc_ping_ms']):.3f} ms (phase 21: "
          f"{med(cluster['rpc_ping_ms']):.3f}); handshake median "
          f"{med(readings['handshake_ms']):.3f} ms; chaos PUT "
          f"{readings['chaos_put_s']:.2f} s, heal "
          f"{readings['chaos_heal_s']:.2f} s, black-holed call "
          f"{readings['blackhole_s']:.3f} s; node boot "
          f"{readings['boot_s']:.1f} s; phase {readings['phase_s']:.1f} s",
          flush=True)
    return {k: v[0] for k, v in launches.items()}, readings


def sm_clock_mhz() -> float:
    """The card's maximum SM clock as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from minio_tpu_torch.device import card_name_and_power_limit
    from minio_tpu_torch.ops import _build
    # no crawler cycle lands inside a reading: phase 12 runs its own
    os.environ["MT_CRAWL_INTERVAL_S"] = str(24 * 3600)
    card = card_name_and_power_limit()
    kind = torch.cuda.get_device_name(0)
    clock = sm_clock_mhz()
    print(f"device: {card} | max SM clock {clock:.0f} MHz | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    kernels = [phase_kernel_a(gen), phase_kernel_b(gen, clock, card),
               phase_kernel_c(gen, clock, card)]
    phase_encode_layout(gen)
    bodies = make_bodies(gen)
    path, shards, path_readings = phase_path(bodies, card)
    mesh_path, mesh_readings = phase_mesh_path(bodies, card, shards)
    s3_path, s3_readings = phase_s3(bodies, card, path_readings)
    mp_path, mp_readings = phase_multipart(card, gen)
    sets_path, sets_readings, (ctl_path, ctl_readings, (
        list_path, list_readings)) = phase_sets(bodies, card, gen,
                                                s3_readings)
    id_path, id_readings = phase_identity(card, gen)
    pools_path, pools_readings = phase_pools(card, gen)
    copy_path, copy_readings, (tr_path, tr_readings), (
        ts_path, ts_readings), (ev_path, ev_readings), (
        repl_path, repl_readings), (
        br_path, br_readings) = phase_copy_lock(bodies, card, gen)
    fed_path, fed_readings = phase_federation(card, gen)
    cl_path, cl_readings = phase_cluster(card, gen)
    tl_path, tl_readings = phase_tls_cluster(card, gen, cl_readings)
    for k in kernels:
        by_path = {"path": path[k["name"]], "mesh_path": mesh_path[k["name"]],
                   "s3_path": s3_path[k["name"]],
                   "multipart_path": mp_path[k["name"]],
                   "sets_path": sets_path[k["name"]],
                   "control_path": ctl_path[k["name"]],
                   "listing_path": list_path[k["name"]],
                   "identity_path": id_path[k["name"]],
                   "pools_path": pools_path[k["name"]],
                   "copy_lock_path": copy_path[k["name"]],
                   "transform_path": tr_path[k["name"]],
                   "tier_select_path": ts_path[k["name"]],
                   "events_path": ev_path[k["name"]],
                   "replication_path": repl_path[k["name"]],
                   "brokers_path": br_path[k["name"]],
                   "identities_path": fed_path[k["name"]],
                   "cluster_path": cl_path[k["name"]],
                   "tls_cluster_path": tl_path[k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print(json.dumps({"card": card, "path": path_readings,
                      "mesh_path": mesh_readings, "s3_path": s3_readings,
                      "multipart_path": mp_readings,
                      "sets_path": sets_readings,
                      "control_path": ctl_readings,
                      "listing_path": list_readings,
                      "identity_path": id_readings,
                      "pools_path": pools_readings,
                      "copy_lock_path": copy_readings,
                      "transform_path": tr_readings,
                      "tier_select_path": ts_readings,
                      "events_path": ev_readings,
                      "replication_path": repl_readings,
                      "brokers_path": br_readings,
                      "identities_path": fed_readings,
                      "cluster_path": cl_readings,
                      "tls_cluster_path": tl_readings}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
